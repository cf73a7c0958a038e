"""Prediction / example visualization: attention-shaded GIFs of trajectories.

Renders the demonstration of a command (or a model prediction) frame by frame
with optional situation-attention shading, writing per-step PNGs plus a GIF —
the capability of reference dataset.py:876-994 without PyQt5 (and, in this
package, without PIL: ``analysis.render`` writes both formats).
"""

import json
import logging
import os
from typing import List, Optional

import numpy as np

from multimodal_seq2seq_gscan_tpu_torch.analysis.render import (
    render_situation, save_gif, save_png)
from multimodal_seq2seq_gscan_tpu_torch.gscan.types import Situation

logger = logging.getLogger(__name__)


def visualize_command(dataset, initial_situation: Situation,
                      command: List[str], demonstration: List[Situation],
                      mission: str, parent_save_dir: str = "",
                      attention_weights: Optional[list] = None) -> str:
    """Render initial + per-step frames to PNGs and a movie.gif."""
    save_directory = dataset.save_directory
    mission_folder = "_".join(
        dataset._vocabulary.translate_word(w) or w for w in command)
    if parent_save_dir:
        mission_folder = os.path.join(parent_save_dir, mission_folder)
        os.makedirs(os.path.join(save_directory, parent_save_dir),
                    exist_ok=True)
    full_dir = os.path.join(save_directory, mission_folder)
    os.makedirs(full_dir, exist_ok=True)
    file_count = len(os.listdir(full_dir))
    final_dir = os.path.join(full_dir, "situation_{}".format(file_count))
    os.makedirs(final_dir, exist_ok=True)

    def frame_weights(step):
        if attention_weights:
            return np.array(attention_weights[step][0])
        return None

    frames = [render_situation(initial_situation,
                               attention_weights=frame_weights(0))]
    for i, situation in enumerate(demonstration):
        if attention_weights:
            assert len(attention_weights) >= len(demonstration), (
                "Unequal number of attention weights and demonstration steps.")
        frames.append(render_situation(
            situation,
            attention_weights=frame_weights(i) if attention_weights else None))

    for i, frame in enumerate(frames):
        name = "initial.png" if i == 0 else "situation_{}.png".format(i - 1)
        save_png(frame, os.path.join(final_dir, name))
    save_gif(frames, os.path.join(final_dir, "movie.gif"), fps=5)
    return final_dir


def visualize_prediction(dataset, predictions_file: str,
                         only_save_errors: bool = False,
                         max_visualized: Optional[int] = None) -> List[str]:
    """Visualize every prediction in a predict.json as an attention GIF (the
    first ``max_visualized`` of those saved, if given)."""
    assert os.path.exists(predictions_file), (
        "Trying to open a non-existing predictions file.")
    with open(predictions_file) as infile:
        data = json.load(infile)
    save_dirs = []
    for predicted_example in data:
        if max_visualized is not None and len(save_dirs) >= max_visualized:
            break
        command = predicted_example["input"]
        prediction = predicted_example["prediction"]
        target = predicted_example["target"]
        meaning = [dataset._vocabulary.translate_word(w) for w in command]
        situation = Situation.from_representation(
            predicted_example["situation"][0])
        predicted_commands, predicted_demonstration, _, _ = \
            dataset.demonstrate_target_commands(
                command, situation, target_commands=prediction)
        target_commands, _, _, _ = dataset.demonstrate_target_commands(
            command, situation, target_commands=target)
        mission = " ".join(["Command:", " ".join(command), "\nMeaning:"]
                           + meaning + ["\nPrediction"]
                           + predicted_example["prediction"]
                           + ["\n      Target:"] + list(target_commands))
        if predicted_example["exact_match"]:
            if only_save_errors:
                continue
            parent_save_dir = "exact_matches"
        else:
            parent_save_dir = "errors"
        save_dirs.append(visualize_command(
            dataset, situation, command, predicted_demonstration,
            mission=mission, parent_save_dir=parent_save_dir,
            attention_weights=predicted_example["attention_weights_situation"]))
    return save_dirs
