"""Exact match over a split (``evaluate`` from the JAX package's
``decode/predict.py``). ``predict_and_save`` and the predict.json writer come
with a later slice."""

from typing import List, Union

import numpy as np
import torch

from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
    make_greedy_decoder, strip_output_sequences)
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import ModelParams
from multimodal_seq2seq_gscan_tpu_torch.utils.metrics import sequence_accuracy


def evaluate(dataset: GroundedScanDataset, params: ModelParams,
             config: ModelConfig, max_decoding_steps: int,
             batch_size: int = 256,
             device: Union[str, torch.device] = "cuda"):
    """(mean token accuracy, % exact match, mean aux position accuracy).

    Decodes ``dataset`` in batches of ``batch_size`` (the last one padded to
    full size) on ``device``, where ``params`` must live.
    """
    decoder = make_greedy_decoder(config, max_decoding_steps)
    accuracies: List[float] = []
    position_accuracies: List[float] = []
    exact_match = 0
    for batch, idx in dataset.get_data_iterator(batch_size=batch_size,
                                                pad_to_full_batch=True):
        batch = batch.to(device)
        output = decoder(params, batch.input_ids, batch.input_lengths,
                         batch.situations, batch.target_positions)
        sequences, _ = strip_output_sequences(output, config.target_eos_idx)
        position_accuracy = output.position_accuracy.cpu().numpy()
        for row, example_idx in enumerate(idx):
            target = dataset.target_ids[int(example_idx)][1:-1].tolist()
            accuracy = sequence_accuracy(sequences[row], target)
            exact_match += accuracy == 100
            accuracies.append(accuracy)
            position_accuracies.append(float(position_accuracy[row]))
    if not accuracies:
        raise ValueError("evaluate() got an empty '{}' split: nothing to "
                         "decode".format(dataset.split))
    return (float(np.mean(accuracies)), 100.0 * exact_match / len(accuracies),
            float(np.mean(position_accuracies)))
