from ribca_tpu_torch.engine.voting import PanelProbs, merge_by_voting  # noqa: F401
from ribca_tpu_torch.engine.ensemble import (  # noqa: F401
    EnsembleRunner,
    prediction_panels,
)
