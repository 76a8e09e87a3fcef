"""Compare per-(term, bounce) radiance dumps: a copy of tools/term_diff.py
(numpy only) beside the port's term_dump.

Inputs are .terms.f32 / .linear.f32 pairs written by
plutracer_tpu_torch/tools/term_dump.py (the port), tools/term_dump.py (the
JAX package) or the instrumented reference build
(tools/refbuild/build_dump.sh, env PLU_DUMP=<base>). Layout: (H, W, 3
terms, 8 bounces, 3 channels), term 0 = emitted-at-vertex, 1 = NEE light
strategy, 2 = NEE BSDF strategy.

Both estimators are extremely heavy-tailed (single linear-space pixels reach
1e6+; the reference's full-image linear mean varies 60%+ run to run), so all
statistics here are tail-robust:
  - per-(term, bounce) trimmed block means (top-k pixels dropped per block),
  - tonemapped u8-space block comparison (the parity gate's metric).

Usage: python -m plutracer_tpu_torch.tools.term_diff OURS_BASE REF_BASE
           [REF_BASE2 ...] [--res 256]

This methodology found a cornell-box parity failure of the JAX package:
bounce>=2 contributions in the image's top (ceiling) region diverged while
every bounce-0/1 term matched to 0.1%.
"""

from __future__ import annotations

import argparse

import numpy as np

NB = 8


def load(base, res):
    terms = np.fromfile(f"{base}.terms.f32", dtype=np.float32)
    terms = terms.reshape(res, res, 3, NB, 3).astype(np.float64)
    lin = np.fromfile(f"{base}.linear.f32", dtype=np.float32)
    lin = lin.reshape(res, res, 3).astype(np.float64)
    return np.nan_to_num(terms, posinf=0.0), np.nan_to_num(lin, posinf=0.0)


def trimblk(x, nblk=16, drop=4):
    """Per-block trimmed mean of a (res, res) map (drops the `drop` largest
    pixels per block — firefly-robust)."""
    res = x.shape[0]
    b = res // nblk
    x = x.reshape(nblk, b, nblk, b).transpose(0, 2, 1, 3).reshape(nblk, nblk, b * b)
    return np.sort(x, axis=-1)[:, :, :-drop].mean(-1)


def tonemap(lin):
    lum = 0.2126 * lin[..., 0] + 0.7152 * lin[..., 1] + 0.0722 * lin[..., 2]
    s = np.where(lum > 0, (lum / (1 + lum)) / np.maximum(lum, 1e-20), 0.0)
    return np.clip(lin * s[..., None], 0, 1) ** (1 / 2.2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ours")
    ap.add_argument("refs", nargs="+")
    ap.add_argument("--res", type=int, default=256)
    args = ap.parse_args(argv)

    O, Olin = load(args.ours, args.res)
    refs = [load(r, args.res) for r in args.refs]
    R = np.mean([t for t, _ in refs], axis=0)
    Rlin = np.mean([l for _, l in refs], axis=0)

    names = ["emit ", "nee_l", "nee_b"]
    print("trimmed block-sum comparison, image top half vs bottom half:")
    print("term  bounces   ours-top  ref-top  ratio | ours-bot  ref-bot  ratio")
    groups = [("b0", [0]), ("b1", [1]), ("b2+", list(range(2, NB)))]
    for k in range(3):
        for gname, bs in groups:
            o = trimblk(O[:, :, k, bs].sum(2).mean(-1))
            r = trimblk(R[:, :, k, bs].sum(2).mean(-1))
            ot, rt = o[:8].sum(), r[:8].sum()
            ob, rb = o[8:].sum(), r[8:].sum()
            if max(ot, rt, ob, rb) < 1e-5:
                continue
            print(f"{names[k]} {gname:4s}   {ot:8.3f} {rt:8.3f}  "
                  f"{ot / max(rt, 1e-9):5.3f} | {ob:8.3f} {rb:8.3f}  "
                  f"{ob / max(rb, 1e-9):5.3f}")

    # tonemap each run SEPARATELY and average the per-run diffs: the
    # tonemap is concave, so tonemap(mean(refs)) is Jensen-brighter than
    # any single run and would masquerade as a systematic deficit in ours
    to = tonemap(Olin)
    blk = lambda x: x.reshape(16, args.res // 16, 16, args.res // 16, 3).mean((1, 3))
    ds = [blk(to) - blk(tonemap(l)) for _, l in refs]
    d = np.mean(ds, axis=0)
    absd = np.mean([np.abs(x).mean() for x in ds])
    print(f"\ntonemapped block |diff| mean (avg over refs): {absd:.5f} "
          f"(signed mean {d.mean():+.5f}; positive = ours brighter)")
    if len(refs) > 1:
        ta, tb = tonemap(refs[0][1]), tonemap(refs[1][1])
        print(f"reference self-noise block |diff|: "
              f"{np.abs(blk(ta) - blk(tb)).mean():.5f}")
    np.set_printoptions(precision=1, suppress=True, linewidth=200)
    print("signed block diff x100 (rows = image top..bottom):")
    print((d.mean(-1) * 100).round(1))


if __name__ == "__main__":
    main()
