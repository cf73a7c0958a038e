"""The streamed training loop: data, steps, periodic dev decode, checkpoints.

The port of ``train`` in the JAX package's ``train/loop.py``, streamed path
only: shuffle each epoch (length-bucketed, from ``np.random.default_rng(
seed)``, so the batches equal the JAX loader's), one ``train_step`` per
batch, metrics every ``print_every`` steps, a greedy dev evaluation every
``evaluate_every`` steps (kernel 2 on the card) that writes the running
checkpoint and copies it to ``model_best`` on a better exact match, and
resume from a checkpoint of either package.

Not ported, and refused by name rather than substituted or ignored: the
resident trainer (``steps_per_execution > 1`` and its ``chunk_layout`` /
``stratified_*`` options, ROADMAP A9), multi-seed campaigns (``seeds``,
A10), a device mesh (A11), k-shot moves (``k > 0``, A14), vocabulary
generation (A14), profiling (``profile_dir``, A12), a device prefetch depth
(``prefetch_depth``, A12) and the full RGB situation
(``simple_situation_representation=False``, which the JAX package refuses
too). Any other keyword raises ``TypeError``; ``test_batch_size`` is taken
and, as in the JAX ``train``, not used (``evaluation_batch_size`` sets the
dev decode's batch). The dev split is read in file order, and
``max_testing_examples`` takes its first examples (the JAX loop shuffles the
dev split without a seed before it takes them).
"""

import logging
import time
from typing import Callable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from multimodal_seq2seq_gscan_tpu_torch.core.batch import Batch
from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.decode.predict import evaluate
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.models.params import count_parameters
from multimodal_seq2seq_gscan_tpu_torch.train import checkpoint as ckpt
from multimodal_seq2seq_gscan_tpu_torch.train.state import (
    Adam, create_train_state)
from multimodal_seq2seq_gscan_tpu_torch.train.step import train_step

logger = logging.getLogger(__name__)


def _not_ported(what: str, item: str):
    raise NotImplementedError("{} is not ported yet (ROADMAP {})".format(
        what, item))


def epoch_stream(training_set: GroundedScanDataset, batch_size: int,
                 rng: np.random.Generator
                 ) -> Iterator[Tuple[Batch, np.ndarray]]:
    """Endless stream of (CPU batch, example indices): one length-bucketed
    shuffle from ``rng`` per epoch, short batches padded to full size."""
    while True:
        training_set.shuffle_data(rng,
                                  bucket_by_length_with_batch_size=batch_size)
        yield from training_set.get_data_iterator(batch_size=batch_size,
                                                  pad_to_full_batch=True)


def train(data_path: str, data_directory: str,
          generate_vocabularies: bool = False,
          input_vocab_path: str = "training_input_vocab.txt",
          target_vocab_path: str = "training_target_vocab.txt",
          embedding_dimension: int = 25, num_encoder_layers: int = 1,
          encoder_dropout_p: float = 0.3, encoder_bidirectional: bool = True,
          training_batch_size: int = 200, max_decoding_steps: int = 120,
          num_decoder_layers: int = 1, decoder_dropout_p: float = 0.3,
          cnn_kernel_size: int = 7, cnn_dropout_p: float = 0.1,
          cnn_hidden_num_channels: int = 50,
          decoder_hidden_size: int = 100, encoder_hidden_size: int = 100,
          learning_rate: float = 0.001, adam_beta_1: float = 0.9,
          adam_beta_2: float = 0.999, lr_decay: float = 0.9,
          lr_decay_steps: float = 20000, resume_from_file: str = "",
          max_training_iterations: int = 100000,
          output_directory: str = "output", print_every: int = 100,
          evaluate_every: int = 1000, conditional_attention: bool = True,
          auxiliary_task: bool = False, weight_target_loss: float = 0.3,
          attention_type: str = "bahdanau", k: int = 0,
          max_training_examples: Optional[int] = None, seed: int = 42,
          mesh=None, max_testing_examples: Optional[int] = None,
          evaluation_batch_size: int = 256, steps_per_execution: int = 1,
          teacher_forced_impl: str = "fused", seeds: str = "",
          device: Union[str, torch.device] = "cuda",
          callback: Optional[Callable[[str, int, dict], None]] = None,
          test_batch_size: Optional[int] = None,
          simple_situation_representation: bool = True,
          profile_dir: str = "", prefetch_depth: int = 3,
          chunk_layout: str = "full", stratified_widths: str = "32",
          stratified_wide_mix: float = 0.0,
          stratified_interleave: bool = False):
    """Train (or resume) the model; returns (TrainState, ModelConfig).

    Arguments mirror the JAX ``train``; a value the port does not honour is
    refused by name (see the module docstring).
    ``callback(kind, iteration, values)``, if given,
    sees every printed window (``kind == "train"``: loss, accuracy,
    exact_match, aux_accuracy, learning_rate, steps_per_s) and every
    evaluation (``"eval"``: accuracy, exact_match, target_accuracy).
    """
    if steps_per_execution > 1:
        _not_ported("The resident trainer (steps_per_execution > 1)", "A9")
    if seeds and len([s for s in str(seeds).split(",") if s.strip()]) > 1:
        _not_ported("Multi-seed training (seeds)", "A10")
    if mesh is not None:
        _not_ported("Data-parallel training (mesh)", "A11")
    if (chunk_layout != "full" or str(stratified_widths) != "32"
            or stratified_wide_mix or stratified_interleave):
        _not_ported("The resident trainer's chunk layouts (chunk_layout, "
                    "stratified_*)", "A9")
    if k:
        _not_ported("The k-shot split move (k > 0)", "A14")
    if generate_vocabularies:
        _not_ported("Vocabulary generation", "A14")
    if profile_dir:
        _not_ported("Profiling (profile_dir)", "A12")
    if prefetch_depth != 3:
        _not_ported("Device prefetch (prefetch_depth)", "A12")
    if not simple_situation_representation:
        raise NotImplementedError(
            "Full RGB input image not implemented. Implement or set "
            "simple_situation_representation.")
    if attention_type != "bahdanau":
        raise NotImplementedError(
            "Luong attention not correctly implemented in the reference; "
            "only 'bahdanau' is supported.")
    device = torch.device(device)

    training_set = GroundedScanDataset(
        data_path, data_directory, split="train",
        input_vocabulary_file=input_vocab_path,
        target_vocabulary_file=target_vocab_path)
    training_set.read_dataset(max_examples=max_training_examples)
    logger.info("Loaded %d training examples.", training_set.num_examples)
    dev_set = GroundedScanDataset(
        data_path, data_directory, split="dev",
        input_vocabulary_file=input_vocab_path,
        target_vocabulary_file=target_vocab_path)
    dev_set.read_dataset(max_examples=max_testing_examples)
    logger.info("Loaded %d dev examples.", dev_set.num_examples)

    config = ModelConfig(
        input_vocabulary_size=training_set.input_vocabulary_size,
        target_vocabulary_size=training_set.target_vocabulary_size,
        num_cnn_channels=training_set.image_channels,
        embedding_dimension=embedding_dimension,
        encoder_hidden_size=encoder_hidden_size,
        decoder_hidden_size=decoder_hidden_size,
        num_encoder_layers=num_encoder_layers,
        num_decoder_layers=num_decoder_layers,
        encoder_bidirectional=encoder_bidirectional,
        cnn_kernel_size=cnn_kernel_size,
        cnn_hidden_num_channels=cnn_hidden_num_channels,
        encoder_dropout_p=encoder_dropout_p,
        decoder_dropout_p=decoder_dropout_p, cnn_dropout_p=cnn_dropout_p,
        conditional_attention=conditional_attention,
        auxiliary_task=auxiliary_task, attention_type=attention_type,
        teacher_forced_impl=teacher_forced_impl,
        input_padding_idx=training_set.input_vocabulary.pad_idx,
        target_pad_idx=training_set.target_vocabulary.pad_idx,
        target_sos_idx=training_set.target_vocabulary.sos_idx,
        target_eos_idx=training_set.target_vocabulary.eos_idx)
    optimizer = Adam(learning_rate=learning_rate, b1=adam_beta_1,
                     b2=adam_beta_2, lr_decay=lr_decay,
                     lr_decay_steps=lr_decay_steps)

    start_iteration = 1
    best_iteration = 1
    best_accuracy = 0.0
    best_exact_match = 0.0
    if resume_from_file:
        state, meta = ckpt.load_checkpoint(resume_from_file, device)
        start_iteration = meta["iteration"]
        best_iteration = meta["best_iteration"]
        best_accuracy = meta["best_accuracy"]
        best_exact_match = meta["best_exact_match"]
    else:
        state = create_train_state(seed, config, optimizer, device)
    logger.info("Total parameters: %d", count_parameters(state.params))

    def log_metrics(iteration, metrics, steps_per_s):
        values = {name: float(value) for name, value in metrics.items()}
        values["learning_rate"] = float(optimizer.schedule(iteration - 1))
        values["steps_per_s"] = steps_per_s
        logger.info(
            "Iteration %08d, loss %8.4f, accuracy %5.2f, exact match "
            "%5.2f, learning_rate %.5f, aux. accuracy target pos %5.2f,"
            " steps/s %6.2f"
            % (iteration, values["loss"], values["accuracy"],
               values["exact_match"], values["learning_rate"],
               values["aux_accuracy"], steps_per_s))
        if callback is not None:
            callback("train", iteration, values)

    def run_evaluation(iteration, state):
        nonlocal best_accuracy, best_exact_match, best_iteration
        logger.info("Evaluating..")
        accuracy, exact_match, target_accuracy = evaluate(
            dev_set, state.params, config,
            max_decoding_steps=max_decoding_steps,
            batch_size=evaluation_batch_size, device=device)
        logger.info(
            "  Evaluation Accuracy: %5.2f Exact Match: %5.2f "
            " Target Accuracy: %5.2f"
            % (accuracy, exact_match, target_accuracy))
        if callback is not None:
            callback("eval", iteration, {"accuracy": accuracy,
                                         "exact_match": exact_match,
                                         "target_accuracy": target_accuracy})
        is_best = exact_match > best_exact_match
        if is_best:
            best_accuracy = accuracy
            best_exact_match = exact_match
            best_iteration = iteration
        # The running checkpoint is always written; the best copy only on a
        # better dev exact match (as in the JAX loop).
        ckpt.save_checkpoint(
            output_directory, state, is_best=is_best,
            best_iteration=best_iteration, best_accuracy=best_accuracy,
            best_exact_match=best_exact_match)

    logger.info("Training starts..")
    training_iteration = start_iteration
    window_start = time.time()
    window_steps = 0
    for batch, _ in epoch_stream(training_set, training_batch_size,
                                 np.random.default_rng(seed)):
        state, metrics = train_step(state, batch.to(device), config,
                                    optimizer, weight_target_loss)
        window_steps += 1
        if training_iteration % print_every == 0:
            metrics = {name: value.item() for name, value in metrics.items()}
            elapsed = time.time() - window_start
            log_metrics(training_iteration, metrics,
                        window_steps / max(elapsed, 1e-9))
            window_start, window_steps = time.time(), 0
        if training_iteration % evaluate_every == 0:
            run_evaluation(training_iteration, state)
            window_start, window_steps = time.time(), 0
        training_iteration += 1
        if training_iteration > max_training_iterations:
            break
    logger.info("Finished training.")
    return state, config
