"""launches_per_step.train: the hand-written kernels' launches a train
step in the window, by the port's own counters (train.kernel_launches)."""


def read(run):
    if run.get("steps", 0) < 1:
        return None
    return sum(run["launches"].values()) / run["steps"]
