"""Static model configuration (a copy of the JAX package's ``ModelConfig``).

The JAX config's ``attention_impl`` switch is not carried over: a kernel
wrapper follows the tensors' device (the CUDA kernel on ``cuda``, its plain
PyTorch version on ``cpu``). ``teacher_forced_impl`` is, with the port's
names: ``"fused"`` (kernels 3 and 4, JAX's ``"pallas"``), ``"step"`` (a loop
over ``decoder_step``, whose attentions are kernel 1, JAX's ``"xla"``) and
``"plain"`` (``ops.teacher_forced.teacher_forced_plain`` with autograd, the
yardstick of the other two).
"""

import logging
from typing import NamedTuple, Optional

TEACHER_FORCED_IMPLS = ("fused", "step", "plain")

logger = logging.getLogger(__name__)
_warned = set()


class ModelConfig(NamedTuple):
    """Hyperparameters of the multimodal seq2seq model.

    Defaults mirror the reference CLI defaults (seq2seq/__main__.py:21-102).
    """

    input_vocabulary_size: int
    target_vocabulary_size: int
    num_cnn_channels: int

    embedding_dimension: int = 25
    encoder_hidden_size: int = 100
    decoder_hidden_size: int = 100
    num_encoder_layers: int = 1
    num_decoder_layers: int = 1
    encoder_bidirectional: bool = True

    cnn_kernel_size: int = 7
    cnn_hidden_num_channels: int = 50

    encoder_dropout_p: float = 0.3
    decoder_dropout_p: float = 0.3
    cnn_dropout_p: float = 0.1

    conditional_attention: bool = True
    auxiliary_task: bool = False
    attention_type: str = "bahdanau"
    # Default from H100 measurements (PERF.md): kernels 3+4.
    teacher_forced_impl: str = "fused"

    input_padding_idx: int = 0
    target_pad_idx: int = 0
    target_sos_idx: int = 1
    target_eos_idx: int = 2

    @property
    def cnn_output_dimension(self) -> int:
        return self.cnn_hidden_num_channels * 3


def decoder_impl(config: ModelConfig, impl: str, flag: str,
                 compute_dtype: Optional[str] = None) -> str:
    """The one rule that picks how the decoder runs: ``impl`` for the
    flagship decoder (one layer, conditional attention) in float32, whose
    weights the kernels' packing (``pack_decoder_weights``) takes, and
    ``"step"`` (a loop over ``decoder_step``) for any other decoder or for
    a bf16 decode (``compute_dtype``; kernel 2 is float32 only, as the TPU
    kernel is), with a warning once per flag, impl, configuration and
    dtype, as the JAX package falls back from its Pallas kernels
    (``decode/greedy.py``, ``models/model.py``).
    ``flag`` names the option: ``"decode_impl"`` or
    ``"teacher_forced_impl"``."""
    flagship = config.num_decoder_layers == 1 and config.conditional_attention
    bf16 = compute_dtype not in (None, "float32")
    if impl == "step" or (flagship and not bf16):
        return impl
    key = (flag, impl, config.num_decoder_layers,
           config.conditional_attention, compute_dtype)
    if key not in _warned:
        _warned.add(key)
        logger.warning(
            "%s=%r takes the flagship decoder (one layer, conditional "
            "attention) in float32; this configuration has "
            "num_decoder_layers=%d, conditional_attention=%s, compute "
            "dtype %s: falling back to 'step'.", flag, impl,
            config.num_decoder_layers, config.conditional_attention,
            compute_dtype or "float32")
    return "step"
