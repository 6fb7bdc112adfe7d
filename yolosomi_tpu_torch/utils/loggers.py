"""The run's results file (counterpart of the results.csv that the JAX
package's train.py writes, :517-524, and of yolosomi_tpu/utils/loggers.py).

`ResultsCSV` writes one row per epoch under the JAX train.py's header,
`epoch,box,obj,cls,P,R,mAP50,mAP,fitness`, five decimals each; a resumed
run appends to the file it finds. TensorBoard and Weights & Biases, which
the JAX package's Loggers feed when their packages are installed, are
not ported (neither package is on the card).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

HEADER = "epoch,box,obj,cls,P,R,mAP50,mAP,fitness"


class ResultsCSV:
    def __init__(self, save_dir):
        self.path = Path(save_dir) / "results.csv"

    def log_epoch(self, epoch: int, train_loss: Sequence[float], results: Sequence[float], fitness: float) -> None:
        """One row: the epoch's mean (box, obj, cls) train losses, then
        (P, R, mAP@.5, mAP@.5:.95) and the fitness."""
        new = not self.path.exists() or self.path.stat().st_size == 0
        with open(self.path, "a") as f:
            if new:
                f.write(HEADER + "\n")
            f.write(f"{epoch}," + ",".join(f"{x:.5f}" for x in (*train_loss[:3], *results[:4], fitness)) + "\n")
