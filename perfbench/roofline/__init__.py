"""The yardstick's peaks and each kernel family's work counted from its
shapes (one module a family)."""
