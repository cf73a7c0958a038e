"""The port's counterparts of the JAX package's driver entry points.

- ``entry(device="cuda")`` returns a callable teacher-forced forward (the
  loss) of the flagship model and its example arguments, on ``device``.
- ``dryrun_multichip(n)`` starts ``n`` gloo ranks on the CPU
  (``parallel/launch.py``) and runs, over their ('data', 'model') mesh:
  one sharded training step, one resident chunk in the full layout and
  one in the stratified layout, and a sharded greedy decode in every
  decode dtype, which must give the single process's tokens. It prints
  ``dryrun_multichip(n) OK, ...``.

    python -c "from multimodal_seq2seq_gscan_tpu_torch.parallel import \\
dryrun; dryrun.dryrun_multichip(2)"
"""

import numpy as np
import torch

from multimodal_seq2seq_gscan_tpu_torch.core.batch import Batch
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig


def _tiny_config_and_batch(batch_size=16, grid=6, channels=16):
    """The JAX package's tiny flagship configuration and its random batch
    (the same numpy draws), as CPU tensors."""
    config = ModelConfig(
        input_vocabulary_size=21, target_vocabulary_size=9,
        num_cnn_channels=channels, embedding_dimension=25,
        encoder_hidden_size=100, decoder_hidden_size=100, cnn_kernel_size=7,
        cnn_hidden_num_channels=50, auxiliary_task=False)

    rng = np.random.RandomState(0)
    t_in, t_out = 8, 16
    input_lengths = rng.randint(3, t_in + 1, size=batch_size).astype(np.int32)
    target_lengths = rng.randint(4, t_out + 1, size=batch_size).astype(np.int32)
    input_ids = np.zeros((batch_size, t_in), dtype=np.int32)
    target_ids = np.zeros((batch_size, t_out), dtype=np.int32)
    for i in range(batch_size):
        input_ids[i, 0] = 1
        input_ids[i, 1:input_lengths[i] - 1] = rng.randint(
            3, 21, size=input_lengths[i] - 2)
        input_ids[i, input_lengths[i] - 1] = 2
        target_ids[i, 0] = 1
        target_ids[i, 1:target_lengths[i] - 1] = rng.randint(
            3, 9, size=target_lengths[i] - 2)
        target_ids[i, target_lengths[i] - 1] = 2
    arrays = (
        input_ids, input_lengths,
        rng.rand(batch_size, grid, grid, channels).astype(np.float32),
        target_ids, target_lengths,
        rng.randint(0, grid * grid, size=batch_size).astype(np.int32),
        rng.randint(0, grid * grid, size=batch_size).astype(np.int32))
    return config, Batch(*(torch.from_numpy(a) for a in arrays))


def entry(device="cuda"):
    """(fn, example_args): ``fn(params, batch)`` is the teacher-forced loss
    of the flagship model, without dropout; the params and the batch lie
    on ``device`` (the card unless the caller asks for the CPU)."""
    from multimodal_seq2seq_gscan_tpu_torch.train.state import (
        Adam, create_train_state)
    from multimodal_seq2seq_gscan_tpu_torch.train.step import loss_fn
    from multimodal_seq2seq_gscan_tpu_torch.utils.precision import (
        full_float32)

    config, batch = _tiny_config_and_batch()
    batch = Batch(*(x.to(device) for x in batch))
    params = create_train_state(0, config, Adam(), device).params

    @torch.no_grad()
    @full_float32()
    def forward_step(params, batch):
        loss, _ = loss_fn(params, config, batch, None, 0.3,
                          deterministic=True)
        return loss

    return forward_step, (params, batch)


DECODE_DTYPES = (None, "bfloat16", "bfloat16_mixed", "bfloat16_keys")


def _dryrun_rank(mesh, batch_size: int) -> dict:
    """One rank's part of ``dryrun_multichip``."""
    from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
        make_greedy_decoder, strip_output_sequences)
    from multimodal_seq2seq_gscan_tpu_torch.parallel.mesh import (
        replicate, shard_batch)
    from multimodal_seq2seq_gscan_tpu_torch.train.resident import (
        ResidentData, index_block_stream, make_train_chunk,
        stratified_index_block_stream)
    from multimodal_seq2seq_gscan_tpu_torch.train.state import (
        Adam, create_train_state)
    from multimodal_seq2seq_gscan_tpu_torch.train.step import train_step

    config, batch = _tiny_config_and_batch(batch_size=batch_size)
    optimizer = Adam()
    state = replicate(mesh, create_train_state(0, config, optimizer, "cpu"))
    state, metrics = train_step(state, shard_batch(mesh, batch), config,
                                optimizer, mesh=mesh)
    loss = float(metrics["loss"])

    # The resident chunk: replicated data, the [K, B] block's columns.
    num_examples = 4 * batch_size
    rng = np.random.RandomState(1)

    def tile(x):
        return torch.cat([x] * 4)

    data = ResidentData(
        input_ids=tile(batch.input_ids),
        input_lengths=tile(batch.input_lengths),
        situations=torch.from_numpy((rng.rand(
            *((num_examples,) + tuple(batch.situations.shape[1:])))
            < 0.2).astype(np.uint8)),
        target_ids=tile(batch.target_ids),
        target_lengths=tile(batch.target_lengths),
        agent_positions=tile(batch.agent_positions),
        target_positions=tile(batch.target_positions))
    chunk = make_train_chunk(config, optimizer, mesh=mesh)
    block = next(index_block_stream(num_examples, batch_size, 2,
                                    np.random.default_rng(0)))
    state, chunk_metrics = chunk(state, data, block)
    cut = int(np.quantile(data.target_lengths.numpy(), 0.8))
    strat_block, spec = next(stratified_index_block_stream(
        data.target_lengths.numpy(), batch_size, 2, np.random.default_rng(0),
        cuts=(max(cut, 1),), wide_mix=0.5))
    state, strat_metrics = chunk(state, data, strat_block, spec)

    # The sharded greedy decode in every decode dtype against the single
    # process's decode of the same dtype.
    inputs = (batch.input_ids, batch.input_lengths, batch.situations,
              batch.target_positions)
    decodes = {}
    for dtype in DECODE_DTYPES:
        impl = "block" if dtype is None else "step"
        single = make_greedy_decoder(config, 12, decode_impl=impl,
                                     compute_dtype=dtype)(
            state.params, *inputs)
        sharded = make_greedy_decoder(config, 12, decode_impl=impl,
                                      compute_dtype=dtype, mesh=mesh)(
            state.params, *shard_batch(mesh, inputs))
        decodes[dtype or "float32"] = (
            strip_output_sequences(single, config.target_eos_idx)[0],
            strip_output_sequences(sharded, config.target_eos_idx)[0])
    return {"loss": loss,
            "chunk_loss": float(chunk_metrics["loss"][-1]),
            "stratified_chunk_loss": float(strat_metrics["loss"][-1]),
            "decodes": decodes}


def dryrun_multichip(n_devices: int) -> None:
    """The sharded step, chunks and decodes over ``n_devices`` gloo ranks
    on the CPU (module docstring)."""
    from multimodal_seq2seq_gscan_tpu_torch.parallel.launch import launch

    batch_size = max(16, 2 * n_devices)
    batch_size = -(-batch_size // n_devices) * n_devices
    result = launch(_dryrun_rank, n_devices, batch_size, device="cpu")
    for name in ("loss", "chunk_loss", "stratified_chunk_loss"):
        assert np.isfinite(result[name]), "{} is not finite".format(name)
    n_seqs = 0
    for dtype, (single, sharded) in result["decodes"].items():
        assert sharded == single, (
            "the sharded decode ({}) diverged from the single process's "
            "decode of the same dtype".format(dtype))
        n_seqs = len(single)
    print("dryrun_multichip({}) OK, loss={:.4f}, chunk_loss={:.4f}, "
          "stratified_chunk_loss={:.4f}, decode_check=passed "
          "({} sequences; dtypes: {})".format(
              n_devices, result["loss"], result["chunk_loss"],
              result["stratified_chunk_loss"], n_seqs,
              ",".join(result["decodes"])))
