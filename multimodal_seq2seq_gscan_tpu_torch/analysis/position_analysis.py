"""Position analysis: compare predicted vs target agent end positions.

Re-executes both the predicted and the ground-truth action sequences in the
world and tabulates row/column/full matches (reference dataset.py:813-874).
"""

import json
import logging
import os

from multimodal_seq2seq_gscan_tpu_torch.analysis.workbook import Workbook
from multimodal_seq2seq_gscan_tpu_torch.gscan.types import Situation

logger = logging.getLogger(__name__)


def position_analysis(dataset, predictions_file: str, workbook: Workbook = None,
                      max_rows_in_sheet: int = 2000):
    assert os.path.exists(predictions_file), (
        "Trying to open a non-existing predictions file.")
    own_workbook = workbook is None
    if own_workbook:
        workbook = Workbook()
    with open(predictions_file) as infile:
        data = json.load(infile)
    sheet_name = os.path.basename(predictions_file).split(".")[0] or "analysis"
    sheet = workbook.add_sheet(sheet_name[-28:])
    sheet.write(0, 0, "Col Matches")
    sheet.write(0, 1, "Row Matches")
    sheet.write(0, 2, "Full Match")
    sheet.write(0, 3, "No Match")
    headers = ("pred col", "actual col", "match", "pred row", "actual row",
               "match", "full match", "no match")
    for col, header in enumerate(headers):
        sheet.write(2, col, header)
    col_matches = row_matches = full_matches = no_matches = 0
    for i, predicted_example in enumerate(data):
        command = predicted_example["input"]
        prediction = predicted_example["prediction"]
        target = predicted_example["target"]
        situation = Situation.from_representation(
            predicted_example["situation"][0])
        _, _, predicted_end_column, predicted_end_row = \
            dataset.demonstrate_target_commands(
                command, situation, target_commands=prediction)
        _, _, actual_end_column, actual_end_row = \
            dataset.demonstrate_target_commands(
                command, situation, target_commands=target)
        col_match = predicted_end_column == actual_end_column
        row_match = predicted_end_row == actual_end_row
        full_match = col_match and row_match
        no_match = not col_match and not row_match
        if i < max_rows_in_sheet:
            sheet.write(i + 3, 0, int(predicted_end_column))
            sheet.write(i + 3, 1, int(actual_end_column))
            sheet.write(i + 3, 2, int(col_match))
            sheet.write(i + 3, 3, int(predicted_end_row))
            sheet.write(i + 3, 4, int(actual_end_row))
            sheet.write(i + 3, 5, int(row_match))
            sheet.write(i + 3, 6, int(full_match))
            sheet.write(i + 3, 7, int(no_match))
        col_matches += int(col_match)
        row_matches += int(row_match)
        full_matches += int(full_match)
        no_matches += int(no_match)
    sheet.write(1, 0, col_matches)
    sheet.write(1, 1, row_matches)
    sheet.write(1, 2, full_matches)
    sheet.write(1, 3, no_matches)
    return workbook if own_workbook else []
