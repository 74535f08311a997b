"""difficp_torch: diffeomorphic point-set registration in PyTorch, with
hand-written CUDA kernels for Hopper (sm_90a).

The port of ``difficp_tpu`` to an NVIDIA H100.  Module paths mirror the JAX
package (``models/psr.py``, ``ops/backend.py``, ...), public functions keep its
layouts (points ``(N, d)``, frames ``(K, N, d)`` with masks), and the JAX
package stays the reference the port is tested against.  Entry points run on
the card unless the caller passes ``device="cpu"``.
"""
