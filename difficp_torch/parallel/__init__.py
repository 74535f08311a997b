from difficp_torch.parallel.atlas import (  # noqa: F401
    AtlasStepOut,
    em_step_frames_sharded,
    frame_range,
    make_atlas_train_step,
    make_mesh,
    shard_psr,
    zero_atlas_memory,
)
from difficp_torch.parallel.launch import init_distributed  # noqa: F401
from difficp_torch.parallel.ring import (  # noqa: F401
    make_local_shoot,
    make_ring_shoot,
    psum,
    ring_hamiltonian,
    ring_rhs_ext,
    ring_rhs_self,
    ring_shift,
)
from difficp_torch.parallel.twoset import (  # noqa: F401
    TwosetStepOut,
    make_sharded_reg_loss,
    make_twoset_step,
    shard_twoset,
    zero_twoset_memory,
)
