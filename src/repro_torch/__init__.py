"""FireFly-P on PyTorch and CUDA: the plastic SNN controller fleet.

The module tree mirrors ``repro`` (the JAX package) path for path, so the
counterpart of ``repro/core/engine.py`` is ``repro_torch/core/engine.py``.
The backend follows the tensors' device: CUDA tensors launch the hand-written
Hopper kernels in ``csrc/``, CPU tensors take each kernel's plain PyTorch
version.  Entry points that create state take ``device=None``, meaning
``"cuda"``; they raise where no card is present rather than fall back.
"""
