"""Port of ``repro.utils``."""
from repro_torch.utils.pytree import (  # noqa: F401
    tree_size,
    tree_bytes,
    named_leaves,
    map_with_names,
    block_paths,
)
from repro_torch.utils.logging import get_logger  # noqa: F401
