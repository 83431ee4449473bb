"""Device ops: each module holds a contract, its plain PyTorch version and the
wrapper of its CUDA kernel (``csrc/``)."""
