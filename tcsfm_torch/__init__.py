"""tcsfm_torch: the PyTorch/CUDA port of tcsfm for one NVIDIA H100.

The JAX package ``tcsfm`` stays the reference; each module here mirrors
the ``tcsfm`` module of the same name, keeps its NHWC layout and its
source-major ``[S, B, ...]`` packing at the public functions, and is held
against it by ``tests/test_torch_*.py``. Importing the package builds
nothing: the CUDA kernels are compiled at their first launch
(``tcsfm_torch.ops._build``).

Entry points: ``tcsfm_torch.infer`` (``build_models``, ``coupled_forward``),
``tcsfm_torch.train.trainer`` (``create_train_state``, ``train_step``,
``eval_step``, ``Trainer``), the refiners (``tcsfm_torch.solver.ba``,
``tcsfm_torch.solver.gauss_newton``), PFT (``tcsfm_torch.solver.pft``,
``PFTOptimizer``) and the CLIs under ``tcsfm_torch.cli`` (``train``,
``evaluate_vo``, ``run_sequential_pft``, ``experiments``, ``demo_pft``,
``import_checkpoint``, ``evaluate_depth_eigen``, ``evaluate_scannet``,
``golden_eval``; ``python -m tcsfm_torch.cli.<name>``).
"""
