"""A tiny cell for CPU runs of the harness: the real files, cut to ten
devices, short splits and a few rounds."""
import copy
import time

from fbench import cell as cells

TINY_CONFIG = {"population": {"devices_per_archetype": 1, "n_train": 64,
                              "n_val": 32, "n_test": 32},
               "fedcd": {"n_devices": 10, "devices_per_round": 4,
                         "local_epochs": 1, "milestones": [2, 5],
                         "late_delete_round": 5, "lr": 0.01},
               "batch_size": 8}
TINY_TRAFFIC = {
    "fedcd": {"setup_rounds": 7, "save_after": 4, "cycle": [5, 7],
              "check_rounds": [1, 2, 5, 6]},
    "fedavg": {"setup_rounds": 3, "check_rounds": [1, 3]},
}


class Job:
    def __init__(self, cell, seed, scratch, trace=False, seconds=0.0):
        self.cell, self.seed, self.seconds, self.trace = (cell, seed,
                                                          seconds, trace)
        self.device, self.t_start, self.scratch = ("cpu",
                                                   time.perf_counter(),
                                                   scratch)


def merge(into, over):
    """Merge ``over`` into ``into`` in place, dict by dict."""
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            merge(into[k], v)
        else:
            into[k] = v


def tiny_cell(name):
    cell = cells.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    merge(cell.config, TINY_CONFIG)
    merge(cell.traffic, TINY_TRAFFIC[cell.traffic["algorithm"]])
    return cell


def tiny_job(name, scratch, seed=5):
    return Job(tiny_cell(name), seed, str(scratch))
