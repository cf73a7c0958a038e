"""Training/testing command line of the PyTorch/CUDA port, flag-compatible
with the JAX package's ``cli/seq2seq.py`` (and so with the reference seq2seq
CLI): the same flags, defaults and choices.

Usage:
    python -m multimodal_seq2seq_gscan_tpu_torch.cli.seq2seq --mode=train ...
    python -m multimodal_seq2seq_gscan_tpu_torch.cli.seq2seq --mode=test ...

It runs on the card (``main(flags, device="cuda")``; the tests pass
``device="cpu"``). ``--teacher_forced_impl`` also takes the port's names
(``models/config.py``); ``--compilation_cache_dir`` is parsed and, as it
configures only JAX's runtime, logged and left unused. ``--seeds`` with
more than one seed trains a multi-seed campaign (``train/multiseed.py``)
into ``<output_directory>/seed_<s>/``; ``--resume_from_file`` then names
the campaign's output directory. ``--data_parallel=n`` (n > 1) runs
``--mode=train`` or ``--mode=test`` on n ranks (``parallel/launch.py``):
one GPU a rank over NCCL, refused when fewer than n GPUs exist; with
``main(flags, device="cpu")`` n gloo ranks on the CPU. A campaign with
``--data_parallel`` is refused, as JAX refuses it. The dataset file is
parsed once for every split, by the C++ scanner when it builds
(``data/dataset.py``'s ``"auto"``).
"""

import argparse
import logging
import os
from typing import Optional, Union

import torch

from multimodal_seq2seq_gscan_tpu_torch.parallel.mesh import Mesh

FORMAT = "%(asctime)-15s %(message)s"
logger = logging.getLogger(__name__)

# JAX's teacher-forced impls, as the port names them.
TEACHER_FORCED_NAMES = {"pallas": "fused", "xla": "step"}
# Flags of the command line that ``train`` does not take.
_NOT_TRAIN_FLAGS = ("mode", "split", "splits", "output_file_name",
                    "compilation_cache_dir", "data_parallel", "decode_dtype")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Sequence to sequence models for Grounded SCAN "
                    "(PyTorch/CUDA)")

    # General arguments.
    parser.add_argument("--mode", type=str, default="run_tests",
                        help="train, test or predict", required=True)
    parser.add_argument("--output_directory", type=str, default="output",
                        help="In this directory the models will be saved. "
                             "Will be created if doesn't exist.")
    parser.add_argument("--resume_from_file", type=str, default="",
                        help="Full path to previously saved model to load. "
                             "For a multi-seed campaign (--seeds) pass the "
                             "campaign output directory instead: each seed "
                             "resumes from <dir>/seed_<s>/checkpoint.msgpack.")

    # Data arguments.
    parser.add_argument("--split", type=str, default="test",
                        help="Which split to get from Grounded Scan.")
    parser.add_argument("--data_directory", type=str,
                        default="data/uniform_dataset",
                        help="Path to folder with data.")
    parser.add_argument("--input_vocab_path", type=str,
                        default="training_input_vocab.txt",
                        help="Path to file with input vocabulary as saved by "
                             "Vocabulary class.")
    parser.add_argument("--target_vocab_path", type=str,
                        default="training_target_vocab.txt",
                        help="Path to file with target vocabulary as saved by "
                             "Vocabulary class.")
    parser.add_argument("--generate_vocabularies",
                        dest="generate_vocabularies", default=False,
                        action="store_true",
                        help="Whether to generate vocabularies based on the "
                             "data.")
    parser.add_argument("--load_vocabularies", dest="generate_vocabularies",
                        action="store_false",
                        help="Whether to use previously saved vocabularies.")

    # Training and learning arguments.
    parser.add_argument("--training_batch_size", type=int, default=50)
    parser.add_argument("--k", type=int, default=0,
                        help="How many examples from the adverb_1 split to "
                             "move to train.")
    parser.add_argument("--test_batch_size", type=int, default=256,
                        help="Batch size for decoding (the decoder is fully "
                             "batched, unlike the reference's batch-1 limit).")
    parser.add_argument("--max_training_examples", type=int, default=None,
                        help="If None all are used.")
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--lr_decay", type=float, default=0.9)
    parser.add_argument("--lr_decay_steps", type=float, default=20000)
    parser.add_argument("--adam_beta_1", type=float, default=0.9)
    parser.add_argument("--adam_beta_2", type=float, default=0.999)
    parser.add_argument("--print_every", type=int, default=100)
    parser.add_argument("--evaluate_every", type=int, default=1000,
                        help="How often to evaluate the model by decoding the "
                             "dev set (without teacher forcing).")
    parser.add_argument("--max_training_iterations", type=int, default=100000)
    parser.add_argument("--weight_target_loss", type=float, default=0.3,
                        help="Only used if --auxiliary_task set.")

    # Testing and predicting arguments.
    parser.add_argument("--max_testing_examples", type=int, default=None)
    parser.add_argument("--splits", type=str, default="test",
                        help="comma-separated list of splits to predict for.")
    parser.add_argument("--max_decoding_steps", type=int, default=30,
                        help="After max_decoding_steps, the decoding process "
                             "is stopped regardless of whether an EOS token "
                             "was generated.")
    parser.add_argument("--output_file_name", type=str, default="predict.json")

    # Situation encoder arguments.
    parser.add_argument("--simple_situation_representation",
                        dest="simple_situation_representation", default=True,
                        action="store_true",
                        help="Represent the situation with 1 vector per grid "
                             "cell.")
    parser.add_argument("--image_situation_representation",
                        dest="simple_situation_representation",
                        action="store_false",
                        help="Represent the situation with the full gridworld "
                             "RGB image.")
    parser.add_argument("--cnn_hidden_num_channels", type=int, default=50)
    parser.add_argument("--cnn_kernel_size", type=int, default=7,
                        help="Size of the largest filter in the world state "
                             "model.")
    parser.add_argument("--cnn_dropout_p", type=float, default=0.1,
                        help="Dropout applied to the output features of the "
                             "world state model.")
    parser.add_argument("--auxiliary_task", dest="auxiliary_task",
                        default=False, action="store_true",
                        help="If set, the model predicts the target location "
                             "from the joint attention over the input "
                             "instruction and world state.")
    parser.add_argument("--no_auxiliary_task", dest="auxiliary_task",
                        action="store_false")

    # Command encoder arguments.
    parser.add_argument("--embedding_dimension", type=int, default=25)
    parser.add_argument("--num_encoder_layers", type=int, default=1)
    parser.add_argument("--encoder_hidden_size", type=int, default=100)
    parser.add_argument("--encoder_dropout_p", type=float, default=0.3,
                        help="Dropout on instruction embeddings and LSTM.")
    parser.add_argument("--encoder_bidirectional",
                        dest="encoder_bidirectional", default=True,
                        action="store_true")
    parser.add_argument("--encoder_unidirectional",
                        dest="encoder_bidirectional", action="store_false")

    # Decoder arguments.
    parser.add_argument("--num_decoder_layers", type=int, default=1)
    parser.add_argument("--attention_type", type=str, default="bahdanau",
                        choices=["bahdanau", "luong"],
                        help="Luong not properly implemented (as in the "
                             "reference).")
    parser.add_argument("--decoder_dropout_p", type=float, default=0.3,
                        help="Dropout on decoder embedding and LSTM.")
    parser.add_argument("--decoder_hidden_size", type=int, default=100)
    parser.add_argument("--teacher_forced_impl", type=str, default="fused",
                        choices=["fused", "step", "plain", "pallas", "xla"],
                        help="Teacher-forced unroll: 'fused' (CUDA kernels "
                             "3 and 4, the default, chosen from H100 "
                             "measurements; the JAX package's 'pallas'), "
                             "'step' (a loop over the decoder step, its "
                             "attentions CUDA kernel 1; JAX's 'xla') or "
                             "'plain' (PyTorch with autograd). 'pallas' and "
                             "'xla' are taken as 'fused' and 'step'. "
                             "'fused' takes the single-layer conditional "
                             "decoder; any other takes 'step'.")
    parser.add_argument("--decode_dtype", type=str, default=None,
                        choices=["float32", "bfloat16", "bfloat16_mixed",
                                 "bfloat16_keys"],
                        help="Greedy-decode loop dtype. Unset = float32. "
                             "bfloat16 halves the "
                             "per-step attention-key HBM traffic (encoder "
                             "stays f32); bfloat16_mixed additionally keeps "
                             "the output head (logits) in f32; "
                             "bfloat16_keys stores ONLY the projected key "
                             "tensors in bf16 (all arithmetic f32); "
                             "float32 keeps reference bit-parity. The bf16 "
                             "variants decode step by step (CUDA kernel 1's "
                             "bf16 form).")
    parser.add_argument("--conditional_attention",
                        dest="conditional_attention", default=True,
                        action="store_true",
                        help="If set, joint attention over the world state "
                             "conditioned on the input instruction is used.")
    parser.add_argument("--no_conditional_attention",
                        dest="conditional_attention", action="store_false")

    # Other arguments.
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--profile_dir", type=str, default="",
                        help="If set, capture a torch.profiler trace of "
                             "a window of training steps to this directory "
                             "(after a warm-up step or chunk whose trace "
                             "is dropped); it shows the port's spans "
                             "gscan.chunk with .bind, .scalars, .upload "
                             "and .launch, gscan.step.optimizer, "
                             "gscan.decode and gscan.decode.check_inputs, "
                             ".encode and .exit_check.")
    parser.add_argument("--compilation_cache_dir", type=str,
                        default=os.path.expanduser("~/.cache/jax_gscan"),
                        help="The JAX package's persistent XLA "
                             "compilation cache. Taken so that JAX command "
                             "lines run unchanged; the port's CUDA kernels "
                             "build once into build/torch_kernels/ instead.")
    parser.add_argument("--data_parallel", type=int, default=0,
                        help="If > 1, train (--mode=train) or decode "
                             "(--mode=test) data-parallel over this many "
                             "devices (mesh over the 'data' axis): one "
                             "process a rank, one GPU a rank over NCCL, or "
                             "gloo ranks when main() is given "
                             "device='cpu' (parallel/launch.py).")
    parser.add_argument("--steps_per_execution", type=int, default=50,
                        help="Optimizer steps fused into one device call "
                             "(a CUDA graph of the chunk over device-resident "
                             "data; train/resident.py). 1 = per-step "
                             "host-streamed batches. Rounded down to divide "
                             "print_every/evaluate_every.")
    parser.add_argument("--chunk_layout", type=str, default="full",
                        choices=["full", "stratified"],
                        help="Resident-chunk index layout: 'full' teacher-"
                             "forces every step at the global max target "
                             "width (the reference-exact trajectory every "
                             "EM-parity campaign trained with); 'stratified' "
                             "slices each chunk into width-matched segments "
                             "— with the default two-class {<=32, rest} "
                             "cut it trains ~2x faster at the same final "
                             "dev EM (200k seed-matrix validation in "
                             "documentation/PERFORMANCE.md round-4).")
    parser.add_argument("--stratified_widths", type=str, default="32",
                        help="Comma-separated class boundaries for "
                             "--chunk_layout=stratified. Default '32' = the "
                             "validated coarse two-class {<=32, rest} "
                             "layout; 'x16' = round lengths up to multiples "
                             "of 16 (fine-grained; fastest chunks but a "
                             "measured quality regression at 200k — "
                             "width-homogeneous batches are non-iid).")
    parser.add_argument("--stratified_wide_mix", type=float, default=0.0,
                        help="Fraction of every widest-class batch backfilled "
                             "with random shorter examples (0 disables). "
                             "Keeps the rare long examples training in mixed "
                             "batches instead of segregated ones.")
    parser.add_argument("--stratified_interleave", dest="stratified_interleave",
                        action="store_true", default=False,
                        help="Spread each width class's steps round-robin "
                             "through the chunk instead of ascending runs.")
    parser.add_argument("--seeds", type=str, default="",
                        help="Comma-separated seed list for a multi-seed "
                             "campaign: every seed trained together on one "
                             "card (one CUDA graph runs each seed's chunk "
                             "in turn), each seed's data order, init and "
                             "dropout those of a single-seed run with "
                             "--seed=<s>. Per-seed runs land in "
                             "<output_directory>/seed_<s>/; resume with "
                             "--resume_from_file=<output_directory>.")
    return parser


def main(flags: Optional[dict] = None,
         device: Union[str, torch.device] = "cuda"):
    """Run ``--mode=train`` or ``--mode=test`` with ``flags`` (the parsed
    command line by default) on ``device``, on ``--data_parallel`` ranks
    when it is above 1."""
    if flags is None:
        flags = vars(build_parser().parse_args())
    for argument, value in flags.items():
        logger.info("{}: {}".format(argument, value))
    if flags.get("compilation_cache_dir"):
        logger.info("--compilation_cache_dir configures the JAX package's "
                    "runtime only; the port's CUDA kernels build into "
                    "build/torch_kernels/ at the root of the checkout.")
    ranks = flags.get("data_parallel") or 0
    if ranks > 1 and len([s for s in str(flags.get("seeds") or "").split(
            ",") if s.strip()]) > 1:
        raise NotImplementedError(
            "--seeds campaign training is single-chip; drop --data_parallel "
            "or train seeds individually.")

    if not os.path.exists(flags["output_directory"]):
        os.makedirs(os.path.join(os.getcwd(), flags["output_directory"]),
                    exist_ok=True)

    if not flags["simple_situation_representation"]:
        raise NotImplementedError(
            "Full RGB input image not implemented. Implement or set "
            "--simple_situation_representation")
    if flags["generate_vocabularies"]:
        assert flags["input_vocab_path"] and flags["target_vocab_path"], (
            "Please specify paths to vocabularies to save.")
    if flags["attention_type"] == "luong":
        raise NotImplementedError(
            "Luong attention is declared broken in the reference and is not "
            "implemented; use --attention_type=bahdanau.")

    if flags["mode"] == "predict":
        raise NotImplementedError()
    if flags["mode"] not in ("train", "test"):
        raise ValueError("Wrong value for parameters --mode ({}).".format(
            flags["mode"]))
    if ranks > 1:
        from multimodal_seq2seq_gscan_tpu_torch.parallel.launch import launch
        launch(run_mode, ranks, flags, device=device)
    else:
        run_mode(None, flags, device)


def run_mode(mesh: Optional[Mesh], flags: dict,
             device: Union[str, torch.device] = "cuda"):
    """``--mode=train`` or ``--mode=test`` on this process, one rank of
    ``mesh`` if given (its device then is the rank's)."""
    if mesh is not None:
        device = mesh.device
    data_path = os.path.join(flags["data_directory"], "dataset.txt")
    if flags["mode"] == "train":
        from multimodal_seq2seq_gscan_tpu_torch.train.loop import train
        options = {name: value for name, value in flags.items()
                   if name not in _NOT_TRAIN_FLAGS}
        options["teacher_forced_impl"] = TEACHER_FORCED_NAMES.get(
            flags["teacher_forced_impl"], flags["teacher_forced_impl"])
        train(data_path=data_path,
              evaluation_batch_size=flags["test_batch_size"], device=device,
              mesh=mesh, **options)
    else:
        run_test(flags, data_path, device=device, mesh=mesh)


def run_test(flags: dict, data_path: str,
             device: Union[str, torch.device] = "cuda",
             mesh: Optional[Mesh] = None):
    """Decode each of ``--splits`` into ``<split>_<output_file_name>``
    (``predict.json``'s records) from ``--resume_from_file``: a checkpoint
    of either package (msgpack), or a reference ``.pth.tar``, ``.pth`` or
    ``.pt`` through ``models/torch_import.py``. The dataset file is parsed
    once for all splits."""
    from multimodal_seq2seq_gscan_tpu_torch.data.dataset import (
        GroundedScanDataset)
    from multimodal_seq2seq_gscan_tpu_torch.decode.predict import (
        predict_and_save)
    from multimodal_seq2seq_gscan_tpu_torch.models.config import ModelConfig
    from multimodal_seq2seq_gscan_tpu_torch.train import checkpoint as ckpt

    assert os.path.exists(os.path.join(
        flags["data_directory"], flags["input_vocab_path"])) and os.path.exists(
        os.path.join(flags["data_directory"], flags["target_vocab_path"])), (
        "No vocabs found at {} and {}".format(flags["input_vocab_path"],
                                              flags["target_vocab_path"]))
    shared_dataset = None  # parse dataset.txt once, reuse across splits
    for split in flags["splits"].split(","):
        logger.info("Loading {} dataset split...".format(split))
        test_set = GroundedScanDataset(
            data_path, flags["data_directory"], split=split,
            input_vocabulary_file=flags["input_vocab_path"],
            target_vocabulary_file=flags["target_vocab_path"],
            generate_vocabulary=False, k=flags["k"],
            k_shot_seed=flags.get("seed"), dataset=shared_dataset)
        test_set.read_dataset(max_examples=None)
        shared_dataset = test_set.dataset
        logger.info("Done Loading {} dataset split.".format(split))
        logger.info("  Loaded {} examples.".format(test_set.num_examples))
        logger.info("  Input vocabulary size: {}".format(
            test_set.input_vocabulary_size))
        logger.info("  Most common input words: {}".format(
            test_set.input_vocabulary.most_common(5)))
        logger.info("  Output vocabulary size: {}".format(
            test_set.target_vocabulary_size))
        logger.info("  Most common target words: {}".format(
            test_set.target_vocabulary.most_common(5)))

        config = ModelConfig(
            input_vocabulary_size=test_set.input_vocabulary_size,
            target_vocabulary_size=test_set.target_vocabulary_size,
            num_cnn_channels=test_set.image_channels,
            embedding_dimension=flags["embedding_dimension"],
            encoder_hidden_size=flags["encoder_hidden_size"],
            decoder_hidden_size=flags["decoder_hidden_size"],
            num_encoder_layers=flags["num_encoder_layers"],
            num_decoder_layers=flags["num_decoder_layers"],
            encoder_bidirectional=flags["encoder_bidirectional"],
            cnn_kernel_size=flags["cnn_kernel_size"],
            cnn_hidden_num_channels=flags["cnn_hidden_num_channels"],
            encoder_dropout_p=flags["encoder_dropout_p"],
            decoder_dropout_p=flags["decoder_dropout_p"],
            cnn_dropout_p=flags["cnn_dropout_p"],
            conditional_attention=flags["conditional_attention"],
            auxiliary_task=flags["auxiliary_task"],
            attention_type=flags["attention_type"],
            input_padding_idx=test_set.input_vocabulary.pad_idx,
            target_pad_idx=test_set.target_vocabulary.pad_idx,
            target_sos_idx=test_set.target_vocabulary.sos_idx,
            target_eos_idx=test_set.target_vocabulary.eos_idx)

        path = flags["resume_from_file"]
        assert os.path.isfile(path), "No checkpoint found at {}".format(path)
        logger.info("Loading checkpoint from file at '{}'".format(path))
        if path.endswith((".pth.tar", ".pth", ".pt")):
            from multimodal_seq2seq_gscan_tpu_torch.models.torch_import import (
                load_reference_checkpoint)
            params, meta = load_reference_checkpoint(path, config, device)
        else:
            state, meta = ckpt.load_checkpoint(path, device)
            params = state.params
        logger.info("Loaded checkpoint '{}' (iter {})".format(
            path, meta["iteration"]))
        output_file_path = os.path.join(
            flags["output_directory"],
            "_".join([split, flags["output_file_name"]]))
        output_file = predict_and_save(
            dataset=test_set, params=params, config=config,
            output_file_path=output_file_path,
            max_decoding_steps=flags["max_decoding_steps"],
            batch_size=flags["test_batch_size"],
            max_testing_examples=flags["max_testing_examples"],
            mesh=mesh, decode_dtype=flags["decode_dtype"], device=device)
        logger.info("Saved predictions to {}".format(output_file))


if __name__ == "__main__":
    logging.basicConfig(format=FORMAT, level=logging.DEBUG,
                        datefmt="%Y-%m-%d %H:%M")
    main()
