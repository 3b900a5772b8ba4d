"""repro_torch.parallel — distributed-optimization utilities over the
port's single-controller ``launch.mesh.Mesh``: int8 gradient compression
with error feedback (``compress.py``) and the GPipe forward schedule
(``pipeline.py``), the port of ``repro.parallel``."""
from .compress import (  # noqa: F401
    compress_int8, compressed_psum_grads, decompress_int8,
)
from .pipeline import pipeline_forward, reference_forward  # noqa: F401
