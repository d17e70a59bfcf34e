"""Text report formatting, single-run and multi-run aggregated (mean ± std).

Format parity with ref: utils.py:667-752 (show_results), minus the Visdom
transport: reports go to stdout / files / the structured logger instead.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def format_results(run: int, results, label_values: Optional[Sequence[str]] = None,
                   agregated: bool = False) -> str:
    text = ""
    if agregated:
        accuracies = [r["Accuracy"] for r in results]
        AAs = [r["AA"] for r in results]
        kappas = [r["Kappa"] for r in results]
        F1_scores = [r["F1 scores"] for r in results]
        Precisions = [r["Precisions"] for r in results]
        F1_scores_mean = np.mean(F1_scores, axis=0)
        F1_scores_std = np.std(F1_scores, axis=0)
        Precisions_mean = np.mean(Precisions, axis=0)
        Precisions_std = np.std(Precisions, axis=0)
        cm = np.mean([r["Confusion matrix"] for r in results], axis=0)
        text += "Agregated results :\n"
    else:
        cm = results["Confusion matrix"]
        accuracy = results["Accuracy"]
        F1scores = results["F1 scores"]
        Precision = results["Precisions"]
        AA = results["AA"]
        kappa = results["Kappa"]

    text += "Confusion matrix (run:{}):\n".format(run)
    text += str(cm)
    text += "---\n"

    if agregated:
        text += "Accuracy: {:.04f} +- {:.04f}\n".format(
            np.mean(accuracies), np.std(accuracies))
    else:
        text += "Accuracy : {:.04f}%\n".format(accuracy)
    text += "---\n"

    text += "F1 scores :\n"
    if agregated:
        for label, score, std in zip(label_values, F1_scores_mean, F1_scores_std):
            text += "\t{}: {:.04f} +- {:.04f}\n".format(label, score, std)
    else:
        for label, score in zip(label_values, F1scores):
            text += "\t{}: {:.04f}\n".format(label, score)
    text += "---\n"

    text += "Precisions :\n"
    if agregated:
        for label, score, std in zip(label_values, Precisions_mean, Precisions_std):
            text += "\t{}: {:.04f} +- {:.04f}\n".format(label, score, std)
    else:
        for label, score in zip(label_values, Precision):
            text += "\t{}: {:.04f}\n".format(label, score)
    text += "---\n"

    if agregated:
        text += "AA: {:.04f} +- {:.04f}\n".format(np.mean(AAs), np.std(AAs))
    else:
        text += "AA : {:.04f}\n".format(AA)

    if agregated:
        text += "Kappa: {:.04f} +- {:.04f}\n".format(np.mean(kappas), np.std(kappas))
    else:
        text += "Kappa: {:.04f}\n".format(kappa)
    return text


def show_results(run: int, results, label_values=None, agregated: bool = False,
                 file=None) -> str:
    """Print (and return) the formatted report (ref: utils.py:667-752)."""
    text = format_results(run, results, label_values, agregated)
    print(text, file=file)
    return text
