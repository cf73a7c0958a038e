#!/usr/bin/env python3
"""The fixture's dev rows that each bf16 decode variant changes, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/bf16_decode_flips.py [--rows N]
                                                            [--batch B]
                                                            [--port]

Decodes the first N (default 4096) dev examples of ``data/bench_fixture``
from its checkpoint with the JAX package's greedy decoder in float32 and in
each bf16 variant (``bfloat16``, ``bfloat16_mixed``, ``bfloat16_keys``), in
batches of B (default 512), and prints the rows whose tokens differ from
the float32 decode. With ``--port`` the port's decoder (``"step"``, on the
CPU) decodes the same batches too, and its rows are printed beside JAX's.
``chip_smoke.py`` holds the card's bf16 decodes to JAX's rows
(``JAX_BF16_FLIPS``).
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import flax.serialization  # noqa: E402
import numpy as np  # noqa: E402

from multimodal_seq2seq_gscan_tpu.decode.greedy import (  # noqa: E402
    make_greedy_decoder as jax_decoder)
from multimodal_seq2seq_gscan_tpu.models import (  # noqa: E402
    ModelConfig as JaxConfig, init_model_params)
from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (  # noqa: E402
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (  # noqa: E402
    load_params, read_checkpoint)

FIXTURE = os.path.join(ROOT, "data", "bench_fixture")
CHECKPOINT = os.path.join(FIXTURE, "model_best.msgpack")
INPUTS = ("input_ids", "input_lengths", "situations", "target_positions")
DTYPES = ("bfloat16", "bfloat16_mixed", "bfloat16_keys")


def differing(tokens, emitted, ref_tokens, ref_emitted):
    """Rows whose emitted tokens differ from the reference decode's."""
    emitted, ref_emitted = emitted > 0, ref_emitted > 0
    return np.nonzero(((tokens * emitted) != (ref_tokens * ref_emitted)).any(1)
                      | (emitted != ref_emitted).any(1))[0]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", type=int, default=4096)
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--port", action="store_true")
    args = parser.parse_args()

    data = GroundedScanDataset(os.path.join(FIXTURE, "dataset.txt"), FIXTURE,
                               split="dev")
    data.read_dataset(max_examples=args.rows)
    sizes = dict(input_vocabulary_size=data.input_vocabulary_size,
                 target_vocabulary_size=data.target_vocabulary_size,
                 num_cnn_channels=data.image_channels)
    jax_config = JaxConfig(**sizes)
    template = jax.eval_shape(lambda key: init_model_params(key, jax_config),
                              jax.random.PRNGKey(0))
    jax_params = flax.serialization.from_state_dict(
        template, read_checkpoint(CHECKPOINT)["params"])
    decoders = {dtype: jax_decoder(jax_config, max_decoding_steps=120,
                                   compute_dtype=dtype)
                for dtype in (None,) + DTYPES}
    flips = {("jax", dtype): [] for dtype in DTYPES}
    if args.port:
        import torch
        from multimodal_seq2seq_gscan_tpu_torch.decode.greedy import (
            make_greedy_decoder)
        from multimodal_seq2seq_gscan_tpu_torch.models.config import (
            ModelConfig)
        config = ModelConfig(**sizes)
        params = load_params(CHECKPOINT, device="cpu")
        port_decoders = {dtype: make_greedy_decoder(
            config, 120, decode_impl="step", compute_dtype=dtype)
            for dtype in (None,) + DTYPES}
        flips.update({("port", dtype): [] for dtype in DTYPES})

    start = 0
    for batch, _, _, _ in data.get_data_iterator(
            batch_size=args.batch, with_representations=False):
        inputs = [np.asarray(getattr(batch, name)) for name in INPUTS]
        outs = {dtype: decode(jax_params, *inputs)
                for dtype, decode in decoders.items()}
        ref = outs[None]
        for dtype in DTYPES:
            rows = differing(np.asarray(outs[dtype].tokens),
                             np.asarray(outs[dtype].emitted_mask),
                             np.asarray(ref.tokens),
                             np.asarray(ref.emitted_mask))
            flips["jax", dtype] += [start + int(row) for row in rows]
        if args.port:
            port_inputs = [getattr(batch, name) for name in INPUTS]
            outs = {dtype: decode(params, *port_inputs)
                    for dtype, decode in port_decoders.items()}
            ref = outs[None]
            for dtype in DTYPES:
                rows = differing(outs[dtype].tokens.numpy(),
                                 outs[dtype].emitted_mask.numpy(),
                                 ref.tokens.numpy(),
                                 ref.emitted_mask.numpy())
                flips["port", dtype] += [start + int(row) for row in rows]
        start += len(inputs[0])
    print("{} dev rows in batches of {}; rows that differ from the float32 "
          "decode:".format(start, args.batch))
    for (package, dtype), rows in flips.items():
        print("  {:4s} {:15s} {}".format(package, dtype, rows))


if __name__ == "__main__":
    main()
