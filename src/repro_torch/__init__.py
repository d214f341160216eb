"""PyTorch + CUDA port of the cold-start FaaS runtime (the JAX package
``repro`` stays beside it as the reference). Module names mirror ``repro``:
``configs``, ``kernels``, ``models``, ``core``."""
