"""Bar plots for dataset statistics and error analysis, written as SVG.

The bars of the reference's matplotlib plots (reference
GroundedScan/helpers.py:69-121): the same sorting, values, error bars, tick
labels (rotated 90 degrees), axis label, title and legend, drawn as a small
SVG document by the standard library, so that plotting needs no matplotlib.
"""

from typing import Any, List, Optional, Sequence
from xml.sax.saxutils import escape

import numpy as np

WIDTH, HEIGHT = 640, 480
# Plot area margins; the bottom one leaves room for the rotated labels
# (matplotlib's subplots_adjust(bottom=0.2) in the reference).
LEFT, RIGHT, TOP, BOTTOM = 70, 20, 40, 130
# matplotlib's first two default colours, at the reference's alpha of 0.5.
COLORS = ("#1f77b4", "#ff7f0e")


def _number(value: float) -> str:
    return "{:.6g}".format(value)


def _svg(series: List[tuple], labels: Sequence[Any], title: str,
         y_axis_label: str, save_path: str,
         legend: Optional[Sequence[str]] = None) -> str:
    """Write bars to ``save_path``. ``series`` holds (x offsets, heights,
    errors or None, width) per group; label i sits under x = i."""
    tops = [0.0]
    bottoms = [0.0]
    for _, heights, errors, _ in series:
        for j, height in enumerate(heights):
            spread = float(errors[j]) if errors is not None else 0.0
            tops.append(float(height) + spread)
            bottoms.append(float(height) - spread)
    y_min, y_max = min(bottoms), max(tops)
    if y_max == y_min:
        y_max = y_min + 1.0
    y_max += 0.05 * (y_max - y_min)
    lefts = [x - width / 2 for xs, _, _, width in series for x in xs]
    rights = [x + width / 2 for xs, _, _, width in series for x in xs]
    x_min = min(lefts, default=-0.5) - 0.2
    x_max = max(rights, default=0.5) + 0.2
    plot_w = WIDTH - LEFT - RIGHT
    plot_h = HEIGHT - TOP - BOTTOM

    def px(x):
        return LEFT + (x - x_min) / (x_max - x_min) * plot_w

    def py(y):
        return TOP + (y_max - y) / (y_max - y_min) * plot_h

    out = ['<svg xmlns="http://www.w3.org/2000/svg" width="{}" height="{}" '
           'viewBox="0 0 {} {}" font-family="sans-serif">'.format(
               WIDTH, HEIGHT, WIDTH, HEIGHT),
           '<rect width="{}" height="{}" fill="white"/>'.format(WIDTH, HEIGHT),
           '<text x="{}" y="{}" text-anchor="middle" font-size="14">{}'
           '</text>'.format(_number(LEFT + plot_w / 2), TOP - 12,
                            escape(str(title)))]
    for k, (xs, heights, errors, width) in enumerate(series):
        color = COLORS[k % len(COLORS)]
        for j, (x, height) in enumerate(zip(xs, heights)):
            height = float(height)
            y0, y1 = py(max(height, 0.0)), py(min(height, 0.0))
            out.append('<rect x="{}" y="{}" width="{}" height="{}" '
                       'fill="{}" fill-opacity="0.5"><title>{}</title>'
                       '</rect>'.format(
                           _number(px(x - width / 2)), _number(y0),
                           _number(px(x + width / 2) - px(x - width / 2)),
                           _number(y1 - y0), color, _number(height)))
            if errors is not None:
                spread = float(errors[j])
                out.append('<line x1="{0}" x2="{0}" y1="{1}" y2="{2}" '
                           'stroke="black"/>'.format(
                               _number(px(x)), _number(py(height - spread)),
                               _number(py(height + spread))))
    # Axes, y ticks, x tick labels, axis label.
    out.append('<path d="M{0} {1}V{2}H{3}" fill="none" stroke="black"/>'.format(
        LEFT, TOP, TOP + plot_h, LEFT + plot_w))
    for tick in np.linspace(y_min, y_max, 6):
        out.append('<text x="{}" y="{}" text-anchor="end" font-size="10">{}'
                   '</text>'.format(LEFT - 4, _number(py(tick) + 3),
                                    "{:.3g}".format(tick)))
    for i, label in enumerate(labels):
        x, y = _number(px(i)), TOP + plot_h + 4
        out.append('<text x="{0}" y="{1}" transform="rotate(-90 {0} {1})" '
                   'text-anchor="end" dominant-baseline="middle" '
                   'font-size="7">{2}</text>'.format(x, y, escape(str(label))))
    out.append('<text x="14" y="{0}" transform="rotate(-90 14 {0})" '
               'text-anchor="middle" font-size="12">{1}</text>'.format(
                   _number(TOP + plot_h / 2), escape(str(y_axis_label))))
    for k, name in enumerate(legend or ()):
        y = TOP + 8 + 16 * k
        out.append('<rect x="{}" y="{}" width="12" height="10" fill="{}" '
                   'fill-opacity="0.5"/><text x="{}" y="{}" font-size="10">'
                   '{}</text>'.format(WIDTH - RIGHT - 80, y, COLORS[k],
                                      WIDTH - RIGHT - 64, y + 9,
                                      escape(str(name))))
    out.append("</svg>")
    with open(save_path, "w") as outfile:
        outfile.write("\n".join(out) + "\n")
    return save_path


def bar_plot(values: dict, title: str, save_path: str, errors=None,
             y_axis_label: str = "Occurrence"):
    """Sorted-by-value bar plot (reference GroundedScan/helpers.py:69-89)."""
    sorted_values = sorted(((v, k) for k, v in values.items()),
                           key=lambda pair: (pair[0], str(pair[1])))
    values_per_label = [v for v, _ in sorted_values]
    labels = [k for _, k in sorted_values]
    if errors:
        sorted_errors = [errors[k] for _, k in sorted_values]
    else:
        sorted_errors = None
    y_pos = np.arange(len(labels))
    return _svg([(y_pos, values_per_label, sorted_errors, 0.8)], labels,
                title, y_axis_label, save_path)


def grouped_bar_plot(values: dict, group_one_key: Any, group_two_key: Any,
                     title: str, save_path: str, errors_group_one=None,
                     errors_group_two=None, y_axis_label: str = "Occurence",
                     sort_on_key: bool = True):
    """Two-group bar plot (reference GroundedScan/helpers.py:92-121)."""
    sorted_values = list(values.items())
    if sort_on_key:
        sorted_values.sort(key=lambda pair: str(pair[0]))
    values_group_one = [v[1].get(group_one_key, 0) for v in sorted_values]
    values_group_two = [v[1].get(group_two_key, 0) for v in sorted_values]
    labels = [v[0] for v in sorted_values]
    y_pos = np.arange(len(labels))
    width = 0.35
    return _svg([(y_pos, values_group_one, None, width),
                 (y_pos + width, values_group_two, None, width)], labels,
                title, y_axis_label, save_path,
                legend=(str(group_one_key), str(group_two_key)))
