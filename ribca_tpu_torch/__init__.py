"""ribca_tpu_torch: the PyTorch and CUDA port of ribca_tpu for NVIDIA Hopper.

It annotates cell types in multiplexed tissue images as ribca_tpu does:
a CHW image, an instance mask and a marker list go in; per-cell labels,
confidences, a CSV and colorized maps come out. Plain tensor code is
PyTorch; the attention kernel of the ViT blocks is hand-written CUDA
(``csrc/attention.cu``). Entry points run on ``device="cuda"`` unless the
caller asks for ``"cpu"``.

Public surface: :class:`ribca_tpu_torch.api.Annotator` and
``ribca_tpu_torch.cli.main`` (``python -m ribca_tpu_torch``).
"""

__version__ = "0.1.0"
