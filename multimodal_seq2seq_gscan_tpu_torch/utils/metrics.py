"""Host-side sequence scoring (reference seq2seq/helpers.py:44-64 semantics)."""

from typing import List


def sequence_accuracy(prediction: List[int], target: List[int]) -> float:
    """Positionwise match percentage after aligning lengths.

    A short prediction is padded with 0, a short target with -1 (so extra
    predicted tokens always count as wrong) — exactly the reference scoring.
    """
    prediction = list(prediction)
    target = list(target)
    if len(prediction) < len(target):
        prediction.extend([0] * (len(target) - len(prediction)))
    if len(target) < len(prediction):
        target.extend([-1] * (len(prediction) - len(target)))
    total = len(target)
    if not total:
        return 0.0
    correct = sum(1 for p, t in zip(prediction, target) if p == t)
    return (correct / total) * 100
