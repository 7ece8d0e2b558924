from ribca_tpu_torch.utils.config import AnnotatorConfig  # noqa: F401
from ribca_tpu_torch.utils.logging import Logger  # noqa: F401
