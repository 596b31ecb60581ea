"""Where the card's gradients part from the JAX package's CPU golden, and why.

    python3 tests/port/grad_golden_witness.py [--rows gt knn] [--out FILE]

Run from the root of a checkout on a machine with one GPU. For each golden
row of ``chip_smoke.py`` (``GRAD_GOLDEN_ROWS``: ``gt`` is PointFusion
``odom='gt'`` at 640x480x30, ``knn`` gradICP 1-NN at 320x240x30), it takes
the port's gradient step of ``sum(points^2)`` to the depths and the
intrinsics twice, on the CPU (remat off) and on the card (remat on, as
``chip_smoke.py`` does), and prints:

- the final map counts: the JAX package's CPU run (from the golden), the
  port on the CPU and the port on the card;
- the gaps of ``chip_smoke.gradient_gaps`` for the port's CPU run against
  the golden and the card against the golden at the golden's 4,096 pixels,
  and for the card against the port's CPU run at every pixel;
- the pixels more than 1e-3 of the largest magnitude off: how many, the
  frames that hold them, and how many of the golden's sampled pixels are
  off against the golden and against the port's CPU run, and in both;
- for ``gt``, the forward frame by frame in lockstep on both devices: each
  frame's map count on each, and the map rows whose bits differ (points,
  normals, features), up to the first frames where the maps part.

If the port's CPU run follows the golden and the card parts from both at
the same pixels, after the frame where the card's map first differs from
the CPU's, the gaps come from the card's arithmetic in the forward (a merge
decided the other way), not from the backward. Writes the numbers as JSON
to ``--out`` (default ``chiprun_out/grad_witness.json``).
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from gradslam_torch import PointFusion, RGBDImages  # noqa: E402

FAR = 1e-3  # of the largest magnitude, as chip_smoke's pixels_over_1e-3
DEVICES = {"cpu": "cpu", "card": "cuda"}


def far_pixels(gd, ref) -> np.ndarray:
    """The flat indices among ``ref``'s pixels where ``gd`` is more than
    ``FAR`` of ``ref``'s largest magnitude off."""
    g = gd.detach().double().cpu().numpy().reshape(-1)[ref["pix"]]
    off = np.abs(g - np.asarray(ref["at"], dtype=np.float64)) > FAR * float(ref["maxabs"])
    return np.asarray(ref["pix"])[off]


def frames_of(pix, shape) -> dict:
    """``{frame: pixels}`` of flat indices into a ``(B, L, H, W)`` depth."""
    _, L, H, W = shape
    frames, counts = np.unique((pix // (H * W)) % L, return_counts=True)
    return {int(f): int(n) for f, n in zip(frames, counts)}


def lockstep_forward(shape, cap, kw) -> list:
    """The gt forward frame by frame on the CPU and the card: each frame's
    map counts and the rows (of the rows both hold) whose points, normals
    or features differ in any bit."""
    out = []
    maps, frames = {}, {}
    for where, dev in DEVICES.items():
        slam = PointFusion(map_capacity=cap, **kw)
        frames[where] = slam._with_normal_pitch(RGBDImages(*cs.grad_inputs(shape, dev)))
        maps[where] = (slam, slam.empty_map(shape[0], cap, device=dev))
    with torch.no_grad():
        for i in range(shape[1]):
            for where in maps:
                slam, pc = maps[where]
                maps[where] = (slam, slam._map(pc, frames[where][:, i]))
            a, b = maps["cpu"][1], maps["card"][1]
            n = int(torch.minimum(a.num_points, b.num_points.cpu()).min())
            rows = [torch.cat([x.points, x.normals, x.features], dim=-1)[:, :n].cpu()
                    for x in (a, b)]
            differ = (rows[0].view(torch.int32) != rows[1].view(torch.int32)).any(-1)
            gap = float((rows[0] - rows[1]).abs().max()) if n else 0.0
            out.append({"frame": i, "cpu": a.num_points.tolist(),
                        "card": b.num_points.cpu().tolist(),
                        "rows_differ": int(differ.sum()), "max_abs_gap": gap})
            print(f"  frame {i:2d}: map cpu {out[-1]['cpu']}, card {out[-1]['card']}, rows "
                  f"whose bits differ {out[-1]['rows_differ']}, largest gap {gap:.3e}",
                  flush=True)
    return out


def witness(key: str, golden) -> dict:
    row = cs.GRAD_GOLDEN_ROWS[key]
    shape, cap, kw, _ = cs.GRAD_ROWS[row]
    print(f"{key}: {row} {shape} capacity {cap} {kw}", flush=True)
    runs = {}
    for where, remat in (("cpu", False), ("card", True)):
        t0 = time.perf_counter()
        pc, _, gd, gk, _ = cs.grad_step(PointFusion(map_capacity=cap, remat=remat, **kw),
                                        cs.grad_inputs(shape, DEVICES[where]))
        runs[where] = (int(pc.num_points.sum()), gd.cpu(), gk.cpu())
        print(f"  {where}: {time.perf_counter() - t0:.1f} s, map {runs[where][0]}", flush=True)
        del pc, gd, gk
    ref_g = cs.golden_ref(golden, key)
    ref_cpu = cs.full_ref(*runs["cpu"][1:])
    far = {"cpu_vs_golden": far_pixels(runs["cpu"][1], ref_g),
           "card_vs_golden": far_pixels(runs["card"][1], ref_g),
           "card_vs_cpu": far_pixels(runs["card"][1], ref_cpu)}
    sampled_card_vs_cpu = np.intersect1d(far["card_vs_cpu"], ref_g["pix"])
    out = {
        "row": row,
        "map_points": {"jax_cpu": int(golden[f"{key}_num_points"]), "port_cpu": runs["cpu"][0],
                       "port_card": runs["card"][0]},
        "gaps": {"cpu_vs_golden": cs.gradient_gaps(*runs["cpu"][1:], ref_g),
                 "card_vs_golden": cs.gradient_gaps(*runs["card"][1:], ref_g),
                 "card_vs_cpu": cs.gradient_gaps(*runs["card"][1:], ref_cpu)},
        "far_pixels": {k: len(v) for k, v in far.items()},
        "far_frames": {k: frames_of(v, shape) for k, v in far.items()},
        "sampled_far_card_vs_cpu": len(sampled_card_vs_cpu),
        "sampled_far_in_both": len(np.intersect1d(far["card_vs_golden"], sampled_card_vs_cpu)),
    }
    for k, v in out.items():
        if k != "row":
            print(f"  {k}: {v}", flush=True)
    if key == "gt":
        out["lockstep"] = lockstep_forward(shape, cap, kw)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", nargs="+", default=["gt"], choices=sorted(cs.GRAD_GOLDEN_ROWS))
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "grad_witness.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grad_golden_witness: no CUDA device available", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}", flush=True)
    cs.disable_tf32()
    cs.load_library()
    golden = np.load(cs.GRAD_GOLDEN)
    result = {"card": cs.card_line(), "rows": {}}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    for key in args.rows:  # written after each row
        result["rows"][key] = witness(key, golden)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"-> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
