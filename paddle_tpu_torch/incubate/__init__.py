"""paddle.incubate: the experimental surface (reference: fluid/incubate/):
`checkpoint` (auto-checkpoint of an epoch loop) and `data_generator`
(feed-file authoring)."""
from . import checkpoint, data_generator  # noqa: F401
