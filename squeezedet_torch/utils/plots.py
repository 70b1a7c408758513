"""PR-curve rendering from scorer plot data (counterpart of
``squeezedet_tpu/utils/plots.py``).

Both scorers (the C++ evaluator and ``data/kitti_ap.py``) write
``plot/<cls>_detection.txt`` data files (41 rows of ``recall easy
moderate hard``); this module renders them with matplotlib, imported
lazily.  Flag-gated from the eval CLI (``--plot_pr``).
"""

from __future__ import annotations

import os
from typing import List

_SERIES = ("Easy", "Moderate", "Hard")


def render_pr_curves(result_dir: str, out_format: str = "png") -> List[str]:
    """Render every ``plot/*_detection.txt`` / ``*_orientation.txt`` in
    ``result_dir`` to an image next to the data file.  Returns the paths
    written; silently returns [] when matplotlib is unavailable."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover
        return []
    import numpy as np

    plot_dir = os.path.join(result_dir, "plot")
    if not os.path.isdir(plot_dir):
        return []
    written = []
    for name in sorted(os.listdir(plot_dir)):
        if not name.endswith(".txt"):
            continue
        data = np.loadtxt(os.path.join(plot_dir, name))
        if data.ndim != 2 or data.shape[1] != 4:
            continue
        is_aos = name.endswith("_orientation.txt")
        cls = name.rsplit("_", 1)[0]
        fig, ax = plt.subplots(figsize=(4.5, 3.15))
        for i, label in enumerate(_SERIES):
            ax.plot(data[:, 0], data[:, i + 1], label=label, linewidth=2)
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        ax.set_xlabel("Recall")
        ax.set_ylabel("Orientation Similarity" if is_aos else "Precision")
        ax.set_title(cls.capitalize())
        ax.legend(loc="lower left", fontsize=8)
        fig.tight_layout()
        out_path = os.path.join(plot_dir,
                                name[:-4] + "." + out_format)
        fig.savefig(out_path, dpi=100)
        plt.close(fig)
        written.append(out_path)
    return written
