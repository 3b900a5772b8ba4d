"""repro_torch.models — the 10 architectures as one pattern-driven stack,
the port of ``repro.models``.

Public API:
    ModelConfig                                   (config.py)
    Transformer, init_model, forward, loss_fn,
    init_cache, decode_step, prefill, encode      (transformer.py)
    params_from_reference, params_to_reference,
    cache_from_reference, cache_to_reference,
    reference_path                                (convert.py)
    param_specs, shardings_for                    (layers.py: the sharding
                                                   rules)
"""
from .config import ModelConfig  # noqa: F401
from .convert import (  # noqa: F401
    cache_from_reference, cache_to_reference, params_from_reference,
    params_to_reference, reference_path,
)
from .layers import param_specs, shardings_for  # noqa: F401
from .transformer import (  # noqa: F401
    Transformer, decode_step, encode, forward, init_cache, init_model,
    loss_fn, prefill,
)
