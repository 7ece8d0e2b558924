from ribca_tpu_torch.panels.vocab import (  # noqa: F401
    CELL_TYPES,
    PANELS,
    PANEL_CLASS_MAPS,
    PANEL_MISSING_BUDGET,
    REPLACEMENTS,
    VOTE_KEYS,
    get_void_vote,
)
from ribca_tpu_torch.panels.parser import MarkerParser  # noqa: F401
