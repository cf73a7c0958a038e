"""Dataset-engine CLI — flag-compatible with the reference GroundedScan CLI
(reference GroundedScan/__main__.py:17-223).

Modes: generate, augment_geca, test, error_analysis, position_analysis,
execute_commands. All of them run on the host (numpy and the standard
library); the statistics' and the error analysis' bar plots are SVG files.

Usage:
    python -m multimodal_seq2seq_gscan_tpu_torch.cli.gscan --mode=generate ...
"""

import argparse
import logging
import os

FORMAT = "%(asctime)-15s %(message)s"
logger = logging.getLogger(__name__)


# The test files of the engine and its analysis tools (no JAX in them).
ENGINE_TESTS = ("test_torch_engine_world.py", "test_torch_engine_oracle.py",
                "test_torch_engine_splits.py", "test_torch_engine_geca.py",
                "test_torch_engine_analysis.py")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Grounded SCAN (PyTorch)")

    # General arguments.
    parser.add_argument("--mode", type=str, default="execute_commands",
                        help="Generate (mode=generate) data, run tests "
                             "(mode=test), analyse end positions "
                             "(mode=position_analysis), run error analysis "
                             "(mode=error_analysis) or visualize predictions "
                             "(mode=execute_commands).")
    parser.add_argument("--load_dataset_from", type=str, default="",
                        help="Path to file with dataset.")
    parser.add_argument("--output_directory", type=str, default="output",
                        help="Folder in which all outputs are stored.")
    parser.add_argument("--predicted_commands_files", type=str,
                        default="predict.json",
                        help="Comma-separated paths to prediction files.")
    parser.add_argument("--save_dataset_as", type=str, default="dataset.txt",
                        help="Filename to save dataset in.")
    parser.add_argument("--count_equivalent_examples",
                        dest="count_equivalent_examples", default=False,
                        action="store_true",
                        help="Count equivalent examples between train and "
                             "test after generation.")
    parser.add_argument("--only_save_errors", dest="only_save_errors",
                        default=False, action="store_true",
                        help="If mode=execute_commands, only save the errors.")
    parser.add_argument("--max_visualized", type=int, default=None,
                        help="If mode=execute_commands, visualize at most this "
                             "many predictions of each file (all if unset).")
    parser.add_argument("--make_dev_set", dest="make_dev_set", default=False,
                        action="store_true")

    # Dataset arguments.
    parser.add_argument("--max_examples", type=int, default=None,
                        help="Max. number of examples to generate.")
    parser.add_argument("--split", type=str, default="generalization",
                        choices=["uniform", "generalization", "target_lengths"])
    parser.add_argument("--k_shot_generalization", type=int, default=0,
                        help="Number of examples of a particular split to add "
                             "to the training set.")
    parser.add_argument("--num_resampling", type=int, default=10,
                        help="Times to resample a semantically equivalent "
                             "situation with different object locations.")
    parser.add_argument("--visualize_per_template", type=int, default=0,
                        help="Visualizations to generate per command template.")
    parser.add_argument("--visualize_per_split", type=int, default=0,
                        help="Visualizations to generate per test split.")
    parser.add_argument("--percentage_train", type=float, default=.7,
                        help="Percentage of examples for the training set.")
    parser.add_argument("--percentage_dev", type=float, default=.05,
                        help="Percentage of examples for the dev set.")
    parser.add_argument("--cut_off_target_length", type=int, default=None,
                        help="Target length above which examples go to the "
                             "test set for --split=target_lengths")

    # World arguments.
    parser.add_argument("--grid_size", type=int, default=6,
                        help="Rows (and columns) in the grid world.")
    parser.add_argument("--min_other_objects", type=int, default=0,
                        help="Minimum amount of objects to place.")
    parser.add_argument("--max_objects", type=int, default=2,
                        help="Maximum amount of objects to place.")
    parser.add_argument("--min_object_size", type=int, default=1,
                        help="Smallest object size.")
    parser.add_argument("--max_object_size", type=int, default=4,
                        help="Biggest object size.")
    parser.add_argument("--other_objects_sample_percentage", type=float,
                        default=.5,
                        help="Percentage of distinct distractor groups to "
                             "place in the world.")

    # Grammar and vocabulary arguments.
    parser.add_argument("--type_grammar", type=str, default="adverb",
                        choices=["simple_intrans", "simple_trans", "normal",
                                 "adverb", "full"])
    parser.add_argument("--intransitive_verbs", type=str, default="walk",
                        help="Comma-separated list of intransitive verbs.")
    parser.add_argument("--transitive_verbs", type=str, default="pull,push",
                        help="Comma-separated list of transitive verbs.")
    parser.add_argument("--adverbs", type=str,
                        default="cautiously,while spinning,hesitantly,"
                                "while zigzagging",
                        help="Comma-separated list of adverbs.")
    parser.add_argument("--nouns", type=str, default="square,cylinder,circle",
                        help="Comma-separated list of nouns.")
    parser.add_argument("--color_adjectives", type=str,
                        default="red,green,yellow,blue",
                        help="Comma-separated list of colors.")
    parser.add_argument("--size_adjectives", type=str, default="big,small",
                        help="Comma-separated list of sizes.")
    parser.add_argument("--sample_vocabulary", type=str, default="default",
                        choices=["default", "sample"],
                        help="Whether to specify own vocabulary or sample a "
                             "nonsensical one.")

    # Only relevant when --sample_vocabulary='sample'.
    parser.add_argument("--max_augmented", type=int, default=100000,
                        help="Max examples to add with --mode=augment_geca.")
    parser.add_argument("--seed", type=int, default=1,
                        help="Seed for the generation RNGs (the reference CLI "
                             "has no seed and generates nondeterministically; "
                             "seeding makes datasets reproducible).")

    parser.add_argument("--num_intransitive_verbs", type=int, default=1)
    parser.add_argument("--num_transitive_verbs", type=int, default=1)
    parser.add_argument("--num_adverbs", type=int, default=6)
    parser.add_argument("--num_nouns", type=int, default=3)
    parser.add_argument("--num_color_adjectives", type=int, default=2)
    parser.add_argument("--num_size_adjectives", type=int, default=2)
    return parser


def main(flags=None):
    from multimodal_seq2seq_gscan_tpu_torch.gscan import GroundedScan

    if flags is None:
        flags = vars(build_parser().parse_args())

    if flags["type_grammar"] == "full":
        raise NotImplementedError(
            "Full type grammar (with conjunctions) not implemented (yet).")

    if flags["mode"] in ("execute_commands", "error_analysis",
                         "position_analysis"):
        assert os.path.exists(flags["load_dataset_from"]), (
            "if mode={}, please specify data location in "
            "--load_dataset_from".format(flags["mode"]))
    if flags["split"] == "target_lengths":
        assert flags["cut_off_target_length"], (
            "Specify --cut_off_target_length if --split=target_lengths.")

    if flags["output_directory"]:
        os.makedirs(os.path.join(os.getcwd(), flags["output_directory"]),
                    exist_ok=True)

    if flags["mode"] == "generate":
        sample = flags["sample_vocabulary"] == "sample"

        def words_or_count(words_key, count_key):
            if sample:
                return flags[count_key]
            return flags[words_key].split(",") if flags[words_key] else []

        grounded_scan = GroundedScan(
            intransitive_verbs=words_or_count("intransitive_verbs",
                                              "num_intransitive_verbs"),
            transitive_verbs=words_or_count("transitive_verbs",
                                            "num_transitive_verbs"),
            adverbs=words_or_count("adverbs", "num_adverbs"),
            nouns=words_or_count("nouns", "num_nouns"),
            color_adjectives=words_or_count("color_adjectives",
                                            "num_color_adjectives"),
            size_adjectives=words_or_count("size_adjectives",
                                           "num_size_adjectives"),
            min_object_size=flags["min_object_size"],
            max_object_size=flags["max_object_size"],
            percentage_train=flags["percentage_train"],
            percentage_dev=flags["percentage_dev"],
            sample_vocabulary=flags["sample_vocabulary"],
            save_directory=flags["output_directory"],
            grid_size=flags["grid_size"], type_grammar=flags["type_grammar"],
            seed=flags.get("seed", 1))

        grounded_scan.get_data_pairs(
            max_examples=flags["max_examples"],
            num_resampling=flags["num_resampling"],
            other_objects_sample_percentage=flags[
                "other_objects_sample_percentage"],
            visualize_per_template=flags["visualize_per_template"],
            visualize_per_split=flags["visualize_per_split"],
            split_type=flags["split"],
            train_percentage=flags["percentage_train"],
            min_other_objects=flags["min_other_objects"],
            k_shot_generalization=flags["k_shot_generalization"],
            make_dev_set=flags["make_dev_set"],
            cut_off_target_length=flags["cut_off_target_length"] or 25)
        logger.info("Gathering dataset statistics...")
        grounded_scan.save_dataset_statistics(split="train")
        if flags["split"] in ("uniform", "target_lengths"):
            if flags["make_dev_set"]:
                grounded_scan.save_dataset_statistics(split="dev")
            grounded_scan.save_dataset_statistics(split="test")
            if flags["split"] == "target_lengths":
                grounded_scan.save_dataset_statistics(split="target_lengths")
        elif flags["split"] == "generalization":
            splits = ["test", "visual", "situational_1", "situational_2",
                      "contextual", "adverb_1", "adverb_2", "visual_easier"]
            if flags["make_dev_set"]:
                splits += ["dev"]
            for split in splits:
                grounded_scan.save_dataset_statistics(split=split)
        dataset_path = grounded_scan.save_dataset(flags["save_dataset_as"])
        grounded_scan.visualize_data_examples()
        logger.info("Saved dataset to {}".format(dataset_path))
        if flags["count_equivalent_examples"]:
            if flags["split"] == "uniform":
                splits_to_count = ["test"]
            elif flags["split"] == "generalization":
                splits_to_count = ["visual", "situational_1", "situational_2",
                                   "contextual"]
            else:
                raise ValueError("Unknown option for flag --split: {}".format(
                    flags["split"]))
            for split in splits_to_count:
                logger.info("Equivalent examples in train and testset: "
                            "{}".format(grounded_scan.count_equivalent_examples(
                                "train", split)))
    elif flags["mode"] == "augment_geca":
        # GECA-style recombination (reference all_experiments.sh:19-21 trains
        # on externally-produced GECA data; this makes it self-contained).
        import random as _random

        from multimodal_seq2seq_gscan_tpu_torch.gscan.geca import GecaAugmenter

        assert os.path.exists(flags["load_dataset_from"]), (
            "if mode=augment_geca, please specify data location in "
            "--load_dataset_from")
        grounded_scan = GroundedScan.load_dataset_from_file(
            flags["load_dataset_from"], flags["output_directory"])
        augmenter = GecaAugmenter(grounded_scan)
        added = augmenter.augment(flags["max_augmented"],
                                  _random.Random(flags.get("seed", 1)))
        dataset_path = grounded_scan.save_dataset(flags["save_dataset_as"])
        logger.info("Saved GECA-augmented dataset (+{} examples) to "
                    "{}".format(added, dataset_path))
    elif flags["mode"] == "execute_commands":
        # The analysis tools need only the dataset header (vocab + grammar +
        # world), never the examples — stream past them (campaign-scale
        # dataset.txt files are multi-GB).
        grounded_scan = GroundedScan.load_dataset_header(
            flags["load_dataset_from"], flags["output_directory"])
        for file in flags["predicted_commands_files"].split(","):
            logger.info("Visualizing predictions from file: {}".format(file))
            grounded_scan.visualize_prediction(
                os.path.join(flags["output_directory"], file),
                only_save_errors=flags["only_save_errors"],
                max_visualized=flags.get("max_visualized"))
            logger.info("Saved visualizations in directory: {}.".format(
                flags["output_directory"]))
    elif flags["mode"] == "position_analysis":
        from multimodal_seq2seq_gscan_tpu_torch.analysis.workbook import Workbook
        workbook = Workbook()
        grounded_scan = GroundedScan.load_dataset_header(
            flags["load_dataset_from"], flags["output_directory"])
        for file in flags["predicted_commands_files"].split(","):
            logger.info("Performing position analysis on file: {}".format(file))
            grounded_scan.position_analysis(
                os.path.join(flags["output_directory"], file),
                workbook=workbook)
            logger.info("Wrote position analysis for {}".format(file))
        outfile_excel = os.path.join(flags["output_directory"],
                                     "position_analysis.xls")
        workbook.save(outfile_excel)
        logger.info("Done.")
    elif flags["mode"] == "test":
        # The engine's own tests, which import nothing of JAX; run without
        # tests/conftest.py, which does.
        logger.info("Running the engine's tests..")
        import subprocess
        import sys
        tests = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), "tests")
        result = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-q"]
            + [os.path.join(tests, name) for name in ENGINE_TESTS],
            check=False)
        raise SystemExit(result.returncode)
    elif flags["mode"] == "error_analysis":
        grounded_scan = GroundedScan.load_dataset_header(
            flags["load_dataset_from"], flags["output_directory"])
        for file in flags["predicted_commands_files"].split(","):
            file_name = file.split(".json")[0]
            logger.info("Performing error analysis on file: {}".format(file))
            save_plots_in = os.path.join(flags["output_directory"], file_name)
            os.makedirs(save_plots_in, exist_ok=True)
            grounded_scan.error_analysis(
                predictions_file=os.path.join(flags["output_directory"], file),
                output_file=os.path.join(save_plots_in, "error_analysis.txt"),
                save_directory=save_plots_in)
            logger.info("Wrote data to path: {}.".format(
                os.path.join(save_plots_in, "error_analysis.txt")))
            logger.info("Saved plots in directory: {}.".format(save_plots_in))
    else:
        raise ValueError("Unknown value for command-line argument "
                         "'mode'={}.".format(flags["mode"]))


if __name__ == "__main__":
    logging.basicConfig(format=FORMAT, level=logging.DEBUG,
                        datefmt="%Y-%m-%d %H:%M")
    main()
