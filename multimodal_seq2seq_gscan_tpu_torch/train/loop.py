"""The training loop: data, steps, periodic dev decode, checkpoints.

The port of ``train`` in the JAX package's ``train/loop.py``. Metrics every
``print_every`` steps, a greedy dev evaluation every ``evaluate_every``
steps (kernel 2 on the card) that writes the running checkpoint and copies
it to ``model_best`` on a better exact match, resume from a checkpoint of
either package, and a torch.profiler trace of ten steps with
``profile_dir``. Two paths, as in JAX:

- resident (``steps_per_execution > 1``, the default 50): the training
  split on the device, chunks of K steps fed by ``[K, B]`` index blocks
  (``chunk_layout`` ``"full"`` or ``"stratified"``, with the
  ``stratified_*`` options), a CUDA graph per chunk on the card
  (``train/resident.py``); K divides both logging periods, and a
  misaligned start and the last partial chunk run as single steps;
- streamed (``steps_per_execution=1``): shuffle each epoch
  (length-bucketed, from ``np.random.default_rng(seed)``, so the batches
  equal the JAX loader's), one ``train_step`` per batch.

The dataset file is parsed once for train and dev (``dataset=``); ``k``
moves k-shot examples of ``adverb_1`` into train and dev, drawn with
``seed`` (the JAX loader's native backend); ``generate_vocabularies`` builds
both vocabularies from the train split and saves them into
``data_directory`` before the dev split loads them. The streamed path
prefetches ``prefetch_depth`` batches to the device (``data/prefetch.py``).

Multi-seed campaigns: ``seeds`` with more than one seed trains them
together (``train/multiseed.py``), each seed as a single-seed run with that
``seed`` would, into ``<output_directory>/seed_<s>/``; ``resume_from_file``
then names the campaign's output directory.

The dev split is read whole and shuffled once, by a permutation from
``np.random.default_rng(seed)``, and each evaluation scores the first
``max_testing_examples`` of that order (all of dev when None), as the JAX
loop scores the first examples of its shuffled dev split. JAX shuffles
from an unseeded generator, so the two packages score different subsets;
the seeded draw makes a run's subset repeat, and a campaign's seed s
score the subset of a single-seed run with seed s. The file is parsed
by the dataset's default backend, ``"auto"`` (``data/dataset.py``: the C++
scanner when it builds, else json), and the dev split shares the parse.

Not ported, and refused by name rather than substituted or ignored: a
device mesh (ROADMAP A11; with ``seeds``, refused as JAX refuses it) and
the full RGB situation (``simple_situation_representation=False``, which
the JAX package refuses too). Any other keyword raises ``TypeError``;
``test_batch_size`` is taken and, as in the JAX ``train``, not used
(``evaluation_batch_size`` sets the dev decode's batch).
"""

import logging
import time
from typing import Callable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from multimodal_seq2seq_gscan_tpu_torch.core.batch import Batch
from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.data.prefetch import (
    prefetch_to_device)
from multimodal_seq2seq_gscan_tpu_torch.decode.predict import evaluate
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.train import checkpoint as ckpt
from multimodal_seq2seq_gscan_tpu_torch.train.multiseed import (
    train_multiseed)
from multimodal_seq2seq_gscan_tpu_torch.train.resident import (
    build_resident_data, gather_batch, host_resident_data, index_block_stream,
    make_train_chunk, resolve_chunk_size, stratified_index_block_stream)
from multimodal_seq2seq_gscan_tpu_torch.train.state import (
    Adam, create_train_state)
from multimodal_seq2seq_gscan_tpu_torch.train.step import train_step
from multimodal_seq2seq_gscan_tpu_torch.utils.logging import log_parameters
from multimodal_seq2seq_gscan_tpu_torch.utils.not_ported import not_ported
from multimodal_seq2seq_gscan_tpu_torch.utils.profiling import StepProfiler

logger = logging.getLogger(__name__)


def epoch_stream(training_set: GroundedScanDataset, batch_size: int,
                 rng: np.random.Generator
                 ) -> Iterator[Tuple[Batch, np.ndarray, list, list]]:
    """Endless stream of the iterator's (CPU batch, example indices, [],
    []): one length-bucketed shuffle from ``rng`` per epoch, short batches
    padded to full size, no representations."""
    while True:
        training_set.shuffle_data(rng,
                                  bucket_by_length_with_batch_size=batch_size)
        yield from training_set.get_data_iterator(
            batch_size=batch_size, pad_to_full_batch=True,
            with_representations=False)


def _train_resident(state, training_set, config, optimizer,
                    weight_target_loss, start_iteration,
                    max_training_iterations, training_batch_size,
                    steps_per_execution, print_every, evaluate_every,
                    epoch_rng, profiler, log_metrics, run_evaluation, device,
                    chunk_layout="full", stratified_options=None):
    """Device-resident training in chunks (``train/resident.py``), the JAX
    ``_train_resident``: K is aligned so print and eval boundaries land on
    chunk ends; a misaligned prefix (a resume from any iteration) and the
    final partial chunk run as single steps on rows of the same stream.
    ``chunk_layout`` picks the index-block stream: "full" (every step at
    the split's widest target) or "stratified" (width-sliced segments)."""
    k = resolve_chunk_size(steps_per_execution, print_every, evaluate_every)
    chunk_fn = make_train_chunk(config, optimizer,
                                weight_target_loss=weight_target_loss)
    host_data = host_resident_data(training_set)
    data = build_resident_data(training_set, device)
    if chunk_layout == "stratified":
        blocks = stratified_index_block_stream(
            host_data.target_lengths, training_batch_size, k, epoch_rng,
            **(stratified_options or {}))
    elif chunk_layout == "full":
        blocks = ((block, None) for block in index_block_stream(
            training_set.num_examples, training_batch_size, k, epoch_rng))
    else:
        raise ValueError("chunk_layout must be 'full' or 'stratified', got "
                         "{!r}".format(chunk_layout))
    pending = []  # rows of a partly used block (prefix and tail steps)

    def take_row():
        if not pending:
            block, _ = next(blocks)
            pending.extend(block)
        return pending.pop(0)

    def take_block():
        if not pending:
            return next(blocks)  # the common case: blocks straight through
        # A resume or tail: a full-width chunk from the leftover rows.
        return np.stack([take_row() for _ in range(k)]), None

    logger.info("Device-resident training: %d examples on the device "
                "(%d bytes), %d-step chunks.", training_set.num_examples,
                data.nbytes, k)
    iteration = start_iteration
    window_start = time.time()
    window_steps = 0

    def at_boundaries(it, state, metrics):
        nonlocal window_start, window_steps
        if it % print_every == 0:
            # On the host before the window closes: the device work of the
            # window is then done.
            metrics = {name: float(value) for name, value in metrics.items()}
            elapsed = time.time() - window_start
            log_metrics(it, metrics, window_steps / max(elapsed, 1e-9))
            window_start, window_steps = time.time(), 0
        if it % evaluate_every == 0:
            run_evaluation(it, state)
            window_start, window_steps = time.time(), 0

    def single_steps(state, iteration, count):
        nonlocal window_steps
        for _ in range(count):
            state, metrics = train_step(state, gather_batch(data, take_row()),
                                        config, optimizer, weight_target_loss)
            window_steps += 1
            at_boundaries(iteration, state, metrics)
            iteration += 1
        return state, iteration

    # Align on the chunk grid (chunks cover (e - k, e] with e % k == 0).
    misaligned = (iteration - 1) % k
    if misaligned:
        state, iteration = single_steps(
            state, iteration,
            min(k - misaligned, max_training_iterations - iteration + 1))
    while iteration <= max_training_iterations:
        if iteration + k - 1 > max_training_iterations:
            state, iteration = single_steps(
                state, iteration, max_training_iterations - iteration + 1)
            break
        profiler.maybe_start(iteration)
        block, segments = take_block()
        state, metrics = chunk_fn(state, data, block, segments)
        profiler.maybe_stop(iteration)
        end_iteration = iteration + k - 1
        window_steps += k
        at_boundaries(end_iteration, state,
                      {name: value[-1] for name, value in metrics.items()})
        iteration = end_iteration + 1
    return state


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
          evaluation_batch_size: int = 256, steps_per_execution: int = 50,
          teacher_forced_impl: str = "fused", seeds: str = "",
          device: Union[str, torch.device] = "cuda",
          callback: Optional[Callable[[str, int, dict], None]] = None,
          test_batch_size: Optional[int] = None,
          simple_situation_representation: bool = True,
          profile_dir: str = "", prefetch_depth: int = 3,
          chunk_layout: str = "full", stratified_widths: str = "32",
          stratified_wide_mix: float = 0.0,
          stratified_interleave: bool = False):
    """Train (or resume) the model; returns (TrainState, ModelConfig), or
    for a multi-seed campaign (StackedTrainState, ModelConfig).

    Arguments mirror the JAX ``train``; a value the port does not honour is
    refused by name (see the module docstring).
    ``callback(kind, iteration, values)``, if given,
    sees every printed window (``kind == "train"``: loss, accuracy,
    exact_match, aux_accuracy, learning_rate, steps_per_s) and every
    evaluation (``"eval"``: accuracy, exact_match, target_accuracy); in a
    campaign each seed's, with ``values["seed"]``.
    """
    seed_list = [int(s) for s in str(seeds or "").split(",") if s.strip()]
    if mesh is not None and len(seed_list) > 1:
        raise NotImplementedError(
            "--seeds campaign training is single-chip; drop --data_parallel "
            "or train seeds individually.")
    if mesh is not None:
        not_ported("Data-parallel training (mesh)", "A11")
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
        target_vocabulary_file=target_vocab_path,
        generate_vocabulary=generate_vocabularies, k=k, k_shot_seed=seed)
    training_set.read_dataset(max_examples=max_training_examples)
    logger.info("Loaded %d training examples.", training_set.num_examples)
    logger.info("  Input vocabulary size training set: %d",
                training_set.input_vocabulary_size)
    logger.info("  Most common input words: %s",
                training_set.input_vocabulary.most_common(5))
    logger.info("  Output vocabulary size training set: %d",
                training_set.target_vocabulary_size)
    logger.info("  Most common target words: %s",
                training_set.target_vocabulary.most_common(5))
    if generate_vocabularies:
        training_set.save_vocabularies(input_vocab_path, target_vocab_path)
        logger.info("Saved vocabularies to %s for input and %s for target.",
                    input_vocab_path, target_vocab_path)
    dev_set = GroundedScanDataset(
        data_path, data_directory, split="dev",
        input_vocabulary_file=input_vocab_path,
        target_vocabulary_file=target_vocab_path,
        dataset=training_set.dataset)
    dev_set.read_dataset()
    # Evaluations score the first max_testing_examples of this order (C.10).
    dev_set.shuffle_data(np.random.default_rng(seed))
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
    stratified_options = dict(
        # "32" (default): the two classes {<=32, rest}; "x16" or "":
        # classes of multiples of 16.
        cuts=(None if str(stratified_widths).strip().lower()
              in ("", "x16") else
              tuple(int(w) for w in str(stratified_widths).split(",")
                    if str(w).strip())),
        wide_mix=float(stratified_wide_mix),
        interleave=bool(stratified_interleave))
    if len(seed_list) > 1:
        stacked, _ = train_multiseed(
            training_set, dev_set, config, optimizer, seeds=seed_list,
            output_directory=output_directory,
            max_training_iterations=max_training_iterations,
            training_batch_size=training_batch_size,
            steps_per_execution=steps_per_execution,
            print_every=print_every, evaluate_every=evaluate_every,
            max_decoding_steps=max_decoding_steps,
            weight_target_loss=weight_target_loss,
            evaluation_batch_size=evaluation_batch_size,
            max_testing_examples=max_testing_examples,
            chunk_layout=chunk_layout,
            stratified_options=stratified_options,
            resume_from_file=resume_from_file, device=device,
            callback=callback, profile_dir=profile_dir)
        return stacked, config

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
    log_parameters(state.params)

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
            batch_size=evaluation_batch_size,
            max_examples_to_evaluate=max_testing_examples, device=device)
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

    profiler = StepProfiler(profile_dir, start_step=start_iteration + 20)
    epoch_rng = np.random.default_rng(seed)
    logger.info("Training starts..")
    if steps_per_execution > 1:
        state = _train_resident(
            state, training_set, config, optimizer, weight_target_loss,
            start_iteration, max_training_iterations, training_batch_size,
            steps_per_execution, print_every, evaluate_every, epoch_rng,
            profiler, log_metrics, run_evaluation, device,
            chunk_layout=chunk_layout,
            stratified_options=stratified_options)
        profiler.close()
        logger.info("Finished training.")
        return state, config

    training_iteration = start_iteration
    window_start = time.time()
    window_steps = 0
    stream = prefetch_to_device(
        epoch_stream(training_set, training_batch_size, epoch_rng),
        depth=prefetch_depth, device=device)
    try:
        for batch, _, _, _ in stream:
            profiler.maybe_start(training_iteration)
            state, metrics = train_step(state, batch, config, optimizer,
                                        weight_target_loss)
            profiler.maybe_stop(training_iteration)
            window_steps += 1
            if training_iteration % print_every == 0:
                metrics = {name: value.item()
                           for name, value in metrics.items()}
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
    finally:
        stream.close()
    profiler.close()
    logger.info("Finished training.")
    return state, config
