"""Error analysis over a predict.json file (reference dataset.py:657-811).

Aggregates accuracy / exact match / position accuracy over nine example
dimensions (target length, input length, verb, manner, referred target,
referred size, distance, direction, actual target) into a txt report, an .xls
workbook, and bar plots (SVG).
"""

import json
import logging
import os
from collections import Counter, defaultdict

import numpy as np

from multimodal_seq2seq_gscan_tpu_torch.analysis.plots import (
    bar_plot, grouped_bar_plot)
from multimodal_seq2seq_gscan_tpu_torch.analysis.workbook import Workbook
from multimodal_seq2seq_gscan_tpu_torch.gscan.types import Situation

logger = logging.getLogger(__name__)

DIMENSIONS = ("target_length", "input_length", "verb_in_command", "manner",
              "referred_target", "referred_size", "distance_to_target",
              "direction_to_target", "actual_target")


def _example_information(dataset, predicted_example: dict) -> dict:
    vocabulary = dataset._vocabulary
    info = {
        "input_length": len(predicted_example["input"]),
        "verb_in_command": vocabulary.translate_word(
            predicted_example["input"][0]),
        "target_length": len(predicted_example["target"]),
    }
    derivation = dataset.parse_derivation_repr(
        predicted_example["derivation"][0])
    arguments = []
    derivation.meaning(arguments)
    target_str, target_predicate = arguments.pop().to_predicate()
    adverb = ""
    for word in derivation.words():
        if word in vocabulary.get_adverbs():
            adverb = word
    info["manner"] = vocabulary.translate_word(adverb)
    info["referred_target"] = " ".join([
        vocabulary.translate_word(target_predicate["size"]),
        vocabulary.translate_word(target_predicate["color"]),
        vocabulary.translate_word(target_predicate["noun"])])
    info["referred_size"] = (vocabulary.translate_word(target_predicate["size"])
                             if target_predicate["size"] else "None")
    situation = Situation.from_representation(predicted_example["situation"][0])
    info["actual_target"] = " ".join([
        str(situation.target_object.object.size),
        situation.target_object.object.color,
        situation.target_object.object.shape])
    info["direction_to_target"] = situation.direction_to_target
    info["distance_to_target"] = situation.distance_to_target
    return info


def error_analysis(dataset, predictions_file: str, output_file: str,
                   save_directory: str):
    assert os.path.exists(predictions_file), (
        "Trying to open a non-existing predictions file.")
    analysis = {dim: defaultdict(lambda: {"accuracy": [], "exact_match": [],
                                          "position_accuracy": []})
                for dim in DIMENSIONS}
    all_accuracies, exact_matches, position_accuracies = [], [], []
    workbook = Workbook()
    with open(predictions_file) as infile:
        data = json.load(infile)
    logger.info("Running error analysis on {} examples.".format(len(data)))
    for predicted_example in data:
        accuracy = predicted_example["accuracy"]
        exact_match = predicted_example["exact_match"]
        position_accuracy = predicted_example["position_accuracy"]
        all_accuracies.append(accuracy)
        exact_matches.append(exact_match)
        position_accuracies.append(position_accuracy)
        info = _example_information(dataset, predicted_example)
        for dim in DIMENSIONS:
            analysis[dim][info[dim]]["accuracy"].append(accuracy)
            analysis[dim][info[dim]]["exact_match"].append(exact_match)
            analysis[dim][info[dim]]["position_accuracy"].append(
                position_accuracy)

    with open(output_file, "w") as outfile:
        outfile.write("Error Analysis\n\n")
        outfile.write(" Mean accuracy: {}\n".format(
            np.mean(np.array(all_accuracies))))
        outfile.write(" Mean position accuracy: {}\n".format(
            np.mean(np.array(position_accuracies))))
        exact_match_counter = Counter(exact_matches)
        outfile.write(" Num. exact matches: {}\n".format(
            exact_match_counter[True]))
        outfile.write(" Num not exact matches: {}\n\n".format(
            exact_match_counter[False]))

        for key, values in analysis.items():
            sheet = workbook.add_sheet(key)
            for col, title in enumerate(
                    (key, "Num examples", "Mean accuracy", "Std. accuracy")):
                sheet.write(0, col, title)
            sheet.write(0, 5, "Mean position accuracy")
            sheet.write(0, 6, "Exact Match")
            sheet.write(0, 7, "Not Exact Match")
            sheet.write(0, 8, "Exact Match Percentage")
            outfile.write("\nDimension {}\n\n".format(key))
            means, position_means = {}, {}
            standard_deviations, position_stds = {}, {}
            exact_match_distributions = {}
            exact_match_relative = {}
            for i, (item_key, item_values) in enumerate(values.items()):
                outfile.write("  {}:{}\n\n".format(key, item_key))
                accuracies = np.array(item_values["accuracy"])
                pos_accuracies = np.array(item_values["position_accuracy"])
                means[item_key] = np.mean(accuracies)
                position_means[item_key] = np.mean(pos_accuracies)
                standard_deviations[item_key] = np.std(accuracies)
                position_stds[item_key] = np.std(pos_accuracies)
                distribution = Counter(item_values["exact_match"])
                exact_match_distributions[item_key] = distribution
                exact_match_relative[item_key] = distribution[True] / (
                    distribution[False] + distribution[True])
                outfile.write("    Num. examples: {}\n".format(
                    len(item_values["accuracy"])))
                outfile.write("    Mean accuracy: {}\n".format(
                    means[item_key]))
                outfile.write("    Min. accuracy: {}\n".format(
                    np.min(accuracies)))
                outfile.write("    Max. accuracy: {}\n".format(
                    np.max(accuracies)))
                outfile.write("    Std. accuracy: {}\n".format(
                    standard_deviations[item_key]))
                outfile.write("    Mean position accuracy: {}\n".format(
                    position_means[item_key]))
                outfile.write("    Min. accuracy: {}\n".format(
                    np.min(pos_accuracies)))
                outfile.write("    Max. accuracy: {}\n".format(
                    np.max(pos_accuracies)))
                outfile.write("    Std. accuracy: {}\n".format(
                    position_stds[item_key]))
                outfile.write("    Num. exact match: {}\n".format(
                    distribution[True]))
                outfile.write("    Num. not exact match: {}\n\n".format(
                    distribution[False]))
                sheet.write(i + 1, 0, item_key)
                sheet.write(i + 1, 1, len(item_values["accuracy"]))
                sheet.write(i + 1, 2, float(means[item_key]))
                sheet.write(i + 1, 3, float(standard_deviations[item_key]))
                sheet.write(i + 1, 4, distribution[True])
                sheet.write(i + 1, 5, float(position_means[item_key]))
                sheet.write(i + 1, 6, distribution[False])
                sheet.write(i + 1, 7, exact_match_relative[item_key])
            outfile.write("\n\n\n")
            bar_plot(means, title=key,
                     save_path=os.path.join(save_directory,
                                            key + "_accuracy.svg"),
                     errors=standard_deviations, y_axis_label="accuracy")
            bar_plot(position_means, title=key,
                     save_path=os.path.join(save_directory,
                                            key + "_position_accuracy.svg"),
                     errors=position_stds, y_axis_label="position_accuracy")
            bar_plot(exact_match_relative, title=key,
                     save_path=os.path.join(save_directory,
                                            key + "_exact_match_rel.svg"),
                     y_axis_label="Exact Match Percentage")
            grouped_bar_plot(values=exact_match_distributions,
                             group_one_key=True, group_two_key=False,
                             title=key + " Exact Matches",
                             save_path=os.path.join(save_directory,
                                                    key + "_exact_match.svg"),
                             sort_on_key=True)
        outfile_excel = output_file.split(".txt")[0] + ".xls"
        workbook.save(outfile_excel)
