"""tcsfm_torch: the PyTorch/CUDA port of tcsfm for one NVIDIA H100.

The JAX package ``tcsfm`` stays the reference; each module here mirrors
the ``tcsfm`` module of the same name, keeps its NHWC layout and its
source-major ``[S, B, ...]`` packing at the public functions, and is held
against it by ``tests/test_torch_*.py``. Importing the package builds
nothing: the CUDA kernels are compiled at their first launch
(``tcsfm_torch.ops._build``).

Entry points: ``tcsfm_torch.infer`` (``build_models``, ``coupled_forward``)
and ``tcsfm_torch.train.trainer`` (``create_train_state``, ``train_step``,
``eval_step``, ``Trainer``).
"""
