"""The LM substrates: schema, layers, the decoder model and its factory."""

from repro_torch.models.api import build_model
from repro_torch.models.convert import load_jax_opt_state, load_jax_params
from repro_torch.models.lm import DecodeCache, DecoderModel

__all__ = ["DecodeCache", "DecoderModel", "build_model", "load_jax_opt_state", "load_jax_params"]
