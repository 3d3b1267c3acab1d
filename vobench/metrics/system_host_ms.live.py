"""VOSystem's own host time a frame, from its logger's stage times
(`tproc`): the prep before the step plus the output section after it
(the keyframe store, the pose-graph log), ms."""


def read(r):
    tp = r.extras.get("tproc")
    if not tp:
        return None
    return sum(p[0] + p[2] for p in tp) / len(tp) * 1e3
