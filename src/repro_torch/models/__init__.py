"""The LM substrates: schema, layers, the three model classes and their factory."""

from repro_torch.models.api import build_model
from repro_torch.models.convert import load_jax_opt_state, load_jax_params
from repro_torch.models.encdec import EncDecCache, EncDecModel
from repro_torch.models.lm import DecodeCache, DecoderModel
from repro_torch.models.xlstm_lm import XLSTMCache, XLSTMModel

__all__ = ["DecodeCache", "DecoderModel", "EncDecCache", "EncDecModel", "XLSTMCache", "XLSTMModel",
           "build_model", "load_jax_opt_state", "load_jax_params"]
