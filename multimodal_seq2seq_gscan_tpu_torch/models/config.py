"""Static model configuration (a copy of the JAX package's ``ModelConfig``).

The JAX config's ``attention_impl`` and ``teacher_forced_impl`` switches are
not carried over: in this package the implementation follows the tensors'
device (a CUDA kernel on ``cuda``, its plain PyTorch version on ``cpu``).
"""

from typing import NamedTuple


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

    input_padding_idx: int = 0
    target_pad_idx: int = 0
    target_sos_idx: int = 1
    target_eos_idx: int = 2

    @property
    def cnn_output_dimension(self) -> int:
        return self.cnn_hidden_num_channels * 3
