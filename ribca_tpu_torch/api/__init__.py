from ribca_tpu_torch.api.annotator import Annotator  # noqa: F401
