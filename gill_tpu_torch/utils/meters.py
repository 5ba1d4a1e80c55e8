"""Console metering (reference gill/utils.py:176-249; gill_tpu's
utils/meters.py). The train step's metrics are already the global
batch's (train/trainer.py), so `AverageMeter.all_reduce` (the reference's
meter.all_reduce, utils.py:225-230) is needed only for values each rank
measured on its own; it sums (sum, count) over the process group and is
a no-op in one process."""

from __future__ import annotations

import enum
from typing import List


class Summary(enum.Enum):
    NONE = 0
    AVERAGE = 1
    SUM = 2
    COUNT = 3


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f",
                 summary_type: Summary = Summary.AVERAGE):
        self.name, self.fmt, self.summary_type = name, fmt, summary_type
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def all_reduce(self):
        """Sums (sum, count) over every process and recomputes avg; nothing
        without a process group."""
        import torch
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_world_size() > 1:
            total = torch.tensor([self.sum, self.count], dtype=torch.float64)
            dist.all_reduce(total)
            self.sum, self.count = total.tolist()
            self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)

    def summary(self):
        if self.summary_type is Summary.NONE:
            return ""
        key = {Summary.AVERAGE: "avg", Summary.SUM: "sum",
               Summary.COUNT: "count"}[self.summary_type]
        return f"{self.name} {getattr(self, key):.3f}"


class ProgressMeter:
    def __init__(self, num_batches: int, meters: List[AverageMeter],
                 prefix: str = ""):
        nd = len(str(num_batches))
        self.batch_fmtstr = "[{:" + str(nd) + "d}/" + str(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries), flush=True)

    def display_summary(self):
        print(" ".join([" *"] + [m.summary() for m in self.meters]), flush=True)
