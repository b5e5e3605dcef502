"""The share of the frames answered in the window whose pose step
(``vo.recover_pose``) found a pose, accepted or not: the frames that run
its triangulation."""

MOVES = "frames_per_s"


def read(run):
    if run.unit != "frames":
        return None
    done = [a for a, d in zip(run.log.answers, run.log.done)
            if d is not None and run.t0 <= d <= run.t1]
    return 100.0 * sum(a["r"] is not None for a in done) / len(done) if done else None
