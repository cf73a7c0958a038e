"""Batched prediction over a dataset, the predict.json writer, exact match.

The port of the JAX package's ``decode/predict.py``: ``predict`` yields one
record per example (tokens, the attention stacks aligned 1:1 with the kept
steps, the textual attention cut to the input's length, the situation and
derivation), ``predict_and_save`` writes them as ``predict.json`` in the
reference's record schema (``input``, ``prediction``, ``derivation``,
``target``, ``situation``, ``attention_weights_input``,
``attention_weights_situation``, ``accuracy``, ``exact_match``,
``position_accuracy``; ``json.dump(..., indent=4)``), and ``evaluate``
scores a split. The decode of batch i + 1 is enqueued before the host
assembles batch i, whose outputs were copied to pinned host memory behind
an event of their own, so the host's wait for them never includes batch
i + 1's decode. ``decode_dtype`` is the decoder's ``compute_dtype``
(``decode/greedy.py``: None or "float32", "bfloat16", "bfloat16_mixed",
"bfloat16_keys").

Under a data-parallel ``mesh`` (``parallel/mesh.py``) every rank walks the
same batches, decodes its rows and receives the global outputs that its
records read (``evaluate``'s leave out the two attention stacks), so every
rank yields the same records and ``evaluate`` returns the same scores on
each; ``predict_and_save`` writes the file on rank 0 alone. The data axis
must divide every batch (a ``ValueError`` names the sizes): the last batch
is padded to full size by default, as JAX's ``pad_to_full_batch`` keeps
its shards equal.
"""

import json
import logging
import time
from typing import Iterator, List, NamedTuple, Optional, Union

import numpy as np
import torch

from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
    GreedyDecodeOutput, make_greedy_decoder, strip_output_sequences)
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import ModelParams
from multimodal_seq2seq_gscan_tpu_torch.parallel.mesh import (
    Mesh, check_mesh, gather_rows, shard_batch)
from multimodal_seq2seq_gscan_tpu_torch.utils.metrics import sequence_accuracy

logger = logging.getLogger(__name__)


class _Decoded(NamedTuple):
    """One decoded batch on its way to the host: the outputs the records
    need, copied without blocking, and the event that says they landed."""

    output: GreedyDecodeOutput
    landed: Optional[torch.cuda.Event]
    input_lengths: np.ndarray
    idx: np.ndarray
    situation_reprs: List[dict]
    derivation_reprs: List[Optional[str]]


def _check_mesh(mesh: Optional[Mesh], batch_size: int,
                device: Union[str, torch.device]) -> torch.device:
    """The decode's device: ``mesh.device`` under a mesh, whose data axis
    must divide ``batch_size``."""
    if check_mesh(mesh) is None:
        return torch.device(device)
    if batch_size % mesh.data_parallel:
        raise ValueError(
            "batch_size {} does not split over the {} ranks of the data "
            "axis".format(batch_size, mesh.data_parallel))
    return mesh.device


def _records(dataset: GroundedScanDataset, params: ModelParams,
             config: ModelConfig, max_decoding_steps: int, batch_size: int,
             max_examples_to_evaluate: Optional[int],
             pad_to_full_batch: bool, device: torch.device,
             with_attention: bool, decode_dtype: Optional[str],
             mesh: Optional[Mesh]) -> Iterator[dict]:
    decoder = make_greedy_decoder(config, max_decoding_steps,
                                  compute_dtype=decode_dtype, mesh=mesh,
                                  gather=False)
    start_time = time.time()
    produced = [0]
    done = [False]

    def launch(batch, idx, situation_reprs, derivation_reprs) -> _Decoded:
        input_lengths = batch.input_lengths.numpy()
        batch = shard_batch(mesh, batch).to(device)
        output = decoder(params, batch.input_ids, batch.input_lengths,
                         batch.situations, batch.target_positions)
        landed = None
        fields = dict(tokens=output.tokens, lengths=output.lengths,
                      position_accuracy=output.position_accuracy)
        if with_attention:
            fields.update(attention_commands=output.attention_commands,
                          attention_situations=output.attention_situations)
        fields = {name: gather_rows(mesh, value)
                  for name, value in fields.items()}
        if device.type == "cuda":
            fields = {name: value.to("cpu", non_blocking=True)
                      for name, value in fields.items()}
            landed = torch.cuda.Event()
            landed.record()
        output = GreedyDecodeOutput(**{
            name: fields.get(name) for name in GreedyDecodeOutput._fields})
        return _Decoded(output, landed, input_lengths, idx, situation_reprs,
                        derivation_reprs)

    def assemble(decoded: _Decoded) -> Iterator[dict]:
        """Host-side record assembly for one decoded batch."""
        if decoded.landed is not None:
            decoded.landed.synchronize()
        output = decoded.output
        sequences, kept_lengths = strip_output_sequences(
            output, eos_idx=config.target_eos_idx)
        if with_attention:
            attn_cmd = output.attention_commands.numpy()
            attn_sit = output.attention_situations.numpy()
        position_accuracy = output.position_accuracy.numpy()
        for row in range(len(decoded.idx)):
            if max_examples_to_evaluate and produced[0] >= \
                    max_examples_to_evaluate:
                done[0] = True
                return
            example_idx = int(decoded.idx[row])
            record = {
                "example_idx": example_idx,
                "input_ids": np.asarray(dataset.input_ids[example_idx]),
                "target_ids": np.asarray(dataset.target_ids[example_idx]),
                "output_ids": sequences[row],
                "derivation_representation":
                    decoded.derivation_reprs[row]
                    if decoded.derivation_reprs else None,
                "situation_representation":
                    decoded.situation_reprs[row]
                    if decoded.situation_reprs else None,
                "position_accuracy": float(position_accuracy[row]),
            }
            if with_attention:
                # Stacks aligned 1:1 with the kept steps; textual weights
                # cut to the true input length (pad weights are exactly 0).
                input_length = int(decoded.input_lengths[row])
                kept = kept_lengths[row]
                record["attention_weights_input"] = [
                    [attn_cmd[row, t, :input_length].tolist()]
                    for t in range(kept)]
                record["attention_weights_situation"] = [
                    [attn_sit[row, t].tolist()] for t in range(kept)]
            yield record
            produced[0] += 1

    # One-batch lookahead: the decode of batch i + 1 is enqueued before the
    # host assembles batch i.
    pending = None
    for batch, idx, situation_reprs, derivation_reprs in \
            dataset.get_data_iterator(
                batch_size=batch_size, pad_to_full_batch=pad_to_full_batch,
                with_representations=with_attention):
        if done[0]:
            break
        decoded = launch(batch, idx, situation_reprs, derivation_reprs)
        if pending is not None:
            yield from assemble(pending)
        pending = decoded
    if pending is not None and not done[0]:
        yield from assemble(pending)
    logger.info("Predicted for {} examples.".format(produced[0]))
    logger.info("Done predicting in {} seconds.".format(
        time.time() - start_time))


def predict(dataset: GroundedScanDataset, params: ModelParams,
            config: ModelConfig, max_decoding_steps: int,
            batch_size: int = 256,
            max_examples_to_evaluate: Optional[int] = None,
            pad_to_full_batch: bool = True, mesh=None,
            decode_dtype: Optional[str] = None,
            device: Union[str, torch.device] = "cuda") -> Iterator[dict]:
    """Greedy-decode the dataset in batches on ``device`` (where ``params``
    live); yield one record dict per example, at most
    ``max_examples_to_evaluate``, with the JAX record's fields. Under a
    ``mesh`` the decode runs on the rank's device, ``mesh.device``."""
    device = _check_mesh(mesh, batch_size, device)
    return _records(dataset, params, config, max_decoding_steps, batch_size,
                    max_examples_to_evaluate, pad_to_full_batch,
                    device, with_attention=True,
                    decode_dtype=decode_dtype, mesh=mesh)


def predict_and_save(dataset: GroundedScanDataset, params: ModelParams,
                     config: ModelConfig, output_file_path: str,
                     max_decoding_steps: int, batch_size: int = 256,
                     max_testing_examples: Optional[int] = None,
                     mesh=None, decode_dtype: Optional[str] = None,
                     device: Union[str, torch.device] = "cuda") -> str:
    """Decode the dataset and write the canonical predict.json (on rank 0
    alone under a ``mesh``)."""
    output = []
    for record in predict(dataset, params, config, max_decoding_steps,
                          batch_size=batch_size,
                          max_examples_to_evaluate=max_testing_examples,
                          mesh=mesh, decode_dtype=decode_dtype,
                          device=device):
        target_no_markers = record["target_ids"][1:-1].tolist()
        accuracy = sequence_accuracy(record["output_ids"], target_no_markers)
        input_str = dataset.array_to_sentence(
            record["input_ids"].tolist(), "input")[1:-1]
        target_str = dataset.array_to_sentence(
            record["target_ids"].tolist(), "target")[1:-1]
        output_str = dataset.array_to_sentence(record["output_ids"], "target")
        output.append({
            "input": input_str,
            "prediction": output_str,
            "derivation": [record["derivation_representation"]],
            "target": target_str,
            "situation": [record["situation_representation"]],
            "attention_weights_input": record["attention_weights_input"],
            "attention_weights_situation":
                record["attention_weights_situation"],
            "accuracy": accuracy,
            "exact_match": accuracy == 100,
            "position_accuracy": record["position_accuracy"],
        })
    if mesh is None or mesh.is_main:
        with open(output_file_path, "w") as outfile:
            logger.info("Wrote predictions for {} examples.".format(
                len(output)))
            json.dump(output, outfile, indent=4)
    return output_file_path


def evaluate(dataset: GroundedScanDataset, params: ModelParams,
             config: ModelConfig, max_decoding_steps: int,
             batch_size: int = 256,
             max_examples_to_evaluate: Optional[int] = None, mesh=None,
             decode_dtype: Optional[str] = None,
             device: Union[str, torch.device] = "cuda"):
    """(mean token accuracy, % exact match, mean aux position accuracy) of
    at most ``max_examples_to_evaluate`` examples, decoded in batches of
    ``batch_size`` (the last padded to full size) on ``device``. The records
    it scores carry no attention lists or representations. Under a
    ``mesh`` every rank returns the same scores."""
    device = _check_mesh(mesh, batch_size, device)
    accuracies: List[float] = []
    target_accuracies: List[float] = []
    exact_match = 0
    for record in _records(dataset, params, config, max_decoding_steps,
                           batch_size, max_examples_to_evaluate, True,
                           device, with_attention=False,
                           decode_dtype=decode_dtype, mesh=mesh):
        accuracy = sequence_accuracy(record["output_ids"],
                                     record["target_ids"][1:-1].tolist())
        if accuracy == 100:
            exact_match += 1
        accuracies.append(accuracy)
        target_accuracies.append(record["position_accuracy"])
    if not accuracies:
        raise ValueError("evaluate() got an empty '{}' split: nothing to "
                         "decode".format(dataset.split))
    return (float(np.mean(np.array(accuracies))),
            (exact_match / len(accuracies)) * 100,
            float(np.mean(np.array(target_accuracies))))
