from repro_torch.models.lm import (
    decode_step,
    init_decode_state,
    init_params,
    prefill,
)

__all__ = ["init_params", "prefill", "decode_step", "init_decode_state"]
