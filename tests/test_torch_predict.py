"""The port's predict, predict.json writer and evaluate equal the JAX
package's, on the CPU.

On the fixture's first 16 dev examples at batch 8 (two full batches, and
12 of them: a second batch padded with zero rows), from the trained
fixture checkpoint:
``predict_and_save``'s JSON equals JAX's record by record, with the same
keys in the same order; ``input``, ``prediction``, ``target``,
``derivation``, ``situation``, ``accuracy`` and ``exact_match`` equal, and
``position_accuracy`` and both attention stacks within rtol 1e-5 / atol
1e-6 (the JAX decode test's attention bar). ``evaluate`` with
``max_examples_to_evaluate`` equals JAX's; a ``mesh`` whose data axis does
not divide the batch is refused by a ``ValueError`` naming the sizes
(sharded prediction: tests/test_torch_parallel.py), and a
``decode_dtype`` that is not one of the decoder's (the bf16 variants are
taken since they were ported, tests/test_torch_decode_dtype.py) by a
``ValueError`` naming the choices.
"""

import json
import os

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from multimodal_seq2seq_gscan_tpu.data.dataset import (
    GroundedScanDataset as JaxDataset)
from multimodal_seq2seq_gscan_tpu.decode.predict import (
    evaluate as jax_evaluate)
from multimodal_seq2seq_gscan_tpu.decode.predict import (
    predict_and_save as jax_predict_and_save)
from multimodal_seq2seq_gscan_tpu.models import ModelConfig as JaxConfig
from multimodal_seq2seq_gscan_tpu.models import init_model_params
from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
    GroundedScanDataset)
from multimodal_seq2seq_gscan_tpu_torch.decode.predict import (
    evaluate, predict, predict_and_save)
from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
from multimodal_seq2seq_gscan_tpu_torch.parallel.mesh import Mesh
from multimodal_seq2seq_gscan_tpu_torch.train.checkpoint import (
    load_params, read_checkpoint)

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "data",
                       "bench_fixture")
CHECKPOINT = os.path.join(FIXTURE, "model_best.msgpack")
N_EXAMPLES = 16
EXACT_KEYS = ("input", "prediction", "target", "derivation", "situation",
              "accuracy", "exact_match")
CLOSE_KEYS = ("position_accuracy", "attention_weights_input",
              "attention_weights_situation")


@pytest.fixture(scope="module")
def fixture():
    jax_data = JaxDataset(
        os.path.join(FIXTURE, "dataset.txt"), FIXTURE, k=0, split="dev",
        input_vocabulary_file="training_input_vocab.txt",
        target_vocabulary_file="training_target_vocab.txt",
        generate_vocabulary=False)
    jax_data.read_dataset(max_examples=N_EXAMPLES)
    port_data = GroundedScanDataset(os.path.join(FIXTURE, "dataset.txt"),
                                    FIXTURE, split="dev")
    port_data.read_dataset(max_examples=N_EXAMPLES)
    kwargs = dict(input_vocabulary_size=port_data.input_vocabulary_size,
                  target_vocabulary_size=port_data.target_vocabulary_size,
                  num_cnn_channels=port_data.image_channels)
    template = jax.eval_shape(
        lambda key: init_model_params(key, JaxConfig(**kwargs)),
        jax.random.PRNGKey(0))
    jax_params = flax.serialization.from_state_dict(
        template, read_checkpoint(CHECKPOINT)["params"])
    return (jax_data, port_data, JaxConfig(**kwargs), ModelConfig(**kwargs),
            jax_params, load_params(CHECKPOINT, device="cpu"))


def test_iterator_keeps_representations_as_jax(fixture):
    jax_data, port_data = fixture[:2]
    for (_, jidx, jsit, jder), (_, pidx, psit, pder) in zip(
            jax_data.get_data_iterator(batch_size=8),
            port_data.get_data_iterator(batch_size=8)):
        np.testing.assert_array_equal(pidx, jidx)
        assert psit == jsit and pder == jder and len(psit) == 8
    _, _, sit, der = next(port_data.get_data_iterator(
        batch_size=8, with_representations=False))
    assert sit == der == []


@pytest.mark.parametrize("examples", [16, 12])
def test_predict_json_equals_jax(fixture, tmp_path, examples):
    jax_data, port_data, jax_config, config, jax_params, params = fixture
    jax_path = jax_predict_and_save(
        jax_data, jax_params, jax_config, str(tmp_path / "jax.json"),
        max_decoding_steps=120, batch_size=8,
        max_testing_examples=examples)
    path = predict_and_save(port_data, params, config,
                            str(tmp_path / "port.json"),
                            max_decoding_steps=120, batch_size=8,
                            max_testing_examples=examples, device="cpu")
    with open(jax_path) as f:
        ref = json.load(f)
    with open(path) as f:
        got = json.load(f)
    assert len(got) == len(ref) == examples
    for record, ref_record in zip(got, ref):
        assert list(record) == list(ref_record)
        for key in EXACT_KEYS:
            assert record[key] == ref_record[key], key
        for key in CLOSE_KEYS:
            want = np.asarray(ref_record[key], np.float64)
            have = np.asarray(record[key], np.float64)
            assert have.shape == want.shape, key
            np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-6,
                                       err_msg=key)
    # The textual rows have the input's length (SOS and EOS included).
    first = got[0]
    assert len(first["attention_weights_input"][0][0]) \
        == len(first["input"]) + 2


def test_predict_records_stop_at_max_examples(fixture):
    port_data, config, params = fixture[1], fixture[3], fixture[5]
    records = list(predict(port_data, params, config, 120, batch_size=8,
                           max_examples_to_evaluate=5, device="cpu"))
    assert [r["example_idx"] for r in records] == list(range(5))


@pytest.mark.parametrize("limit", [None, 11])
def test_evaluate_equals_jax(fixture, limit):
    jax_data, port_data, jax_config, config, jax_params, params = fixture
    ref = jax_evaluate(jax_data, jax_params, jax_config, 120, batch_size=8,
                       max_examples_to_evaluate=limit)
    got = evaluate(port_data, params, config, 120, batch_size=8,
                   max_examples_to_evaluate=limit, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("keyword,value,item", [
    ("mesh", Mesh(None, 0, 3, 3, 1, torch.device("cpu"), "gloo"),
     "batch_size 256 does not split over the 3 ranks"),
    ("decode_dtype", "float16", "compute_dtype")])
@pytest.mark.parametrize("entry", ["predict", "evaluate"])
def test_mesh_and_decode_dtype_are_refused(fixture, entry, keyword, value,
                                           item):
    port_data, config, params = fixture[1], fixture[3], fixture[5]
    with pytest.raises(ValueError, match=item):
        if entry == "predict":
            next(predict(port_data, params, config, 120, device="cpu",
                         **{keyword: value}))
        else:
            evaluate(port_data, params, config, 120, device="cpu",
                     **{keyword: value})
