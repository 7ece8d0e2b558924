from ribca_tpu_torch.models.vit import (  # noqa: F401
    VisionTransformer,
    build_panel_model,
    cast_for_compute,
)
from ribca_tpu_torch.models.params import (  # noqa: F401
    random_vit_tree,
    vit_state_dict,
)
from ribca_tpu_torch.models.store import load_params  # noqa: F401
