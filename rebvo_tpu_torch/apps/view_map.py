"""CLI: offline map viewer (PyTorch port of rebvo_tpu/apps/view_map.py;
the reference's kf_visualizer, app/kf_visualizer/main.cpp): loads a
keyframe store and draws the unprojected keylines and the keyframe
trajectory into a PNG (matplotlib 3D, headless). It only reads the file
and draws on the host, so it needs no device; matplotlib is imported
inside `main`.

    python -m rebvo_tpu_torch.apps.view_map kf_list.npz --out map.png
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("kf_file")
    ap.add_argument("--out", default="map.png")
    ap.add_argument("--zfm", type=float, default=457.975)
    ap.add_argument("--cx", type=float, default=367.215)
    ap.add_argument("--cy", type=float, default=248.375)
    ap.add_argument("--max-points", type=int, default=4000)
    ap.add_argument("--s-rho-max", type=float, default=1.0)
    args = ap.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from rebvo_tpu_torch.backend.keyframe import load_keyframes

    store = load_keyframes(args.kf_file, device="cpu")
    count = int(store.count)
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")

    traj = []
    for f in range(count):
        if not bool(store.valid[f]):
            continue
        Pose = store.Pose[f].numpy()
        Pos = store.Pos[f].numpy()
        K = float(store.K_scale[f])
        traj.append(Pos)
        sel = store.klm.valid[f].numpy() & \
            (store.klm.s_rho[f].numpy() < args.s_rho_max)
        idx = np.where(sel)[0]
        if idx.size > args.max_points:
            idx = idx[:: idx.size // args.max_points + 1]
        px = store.klm.px[f].numpy()[idx]
        py = store.klm.py[f].numpy()[idx]
        z = 1.0 / np.clip(store.klm.rho[f].numpy()[idx], 1e-3, 20.0)
        X = np.stack([px * z / args.zfm, py * z / args.zfm, z])
        Xw = Pose @ (X * K) + Pos[:, None]
        ax.scatter(Xw[0], Xw[2], -Xw[1], s=0.5, c=z, cmap="viridis",
                   alpha=0.5)

    if traj:
        T = np.stack(traj)
        ax.plot(T[:, 0], T[:, 2], -T[:, 1], "r-o", markersize=3,
                label="keyframes")
        ax.legend()
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("-y")
    fig.savefig(args.out, dpi=130, bbox_inches="tight")
    print(f"wrote {args.out} ({count} keyframes)")


if __name__ == "__main__":
    main()
