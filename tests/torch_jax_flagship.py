"""The flagship recipe on demo-box, the port against the JAX package, on
the CPU: the two tools' curves step by step, and the first step's loss
and gradients leaf by leaf.

    python tests/torch_jax_flagship.py curves [--res 32] [--steps 40] [--phase2-steps 20]
        [--target-n 16] [--no-fma]
    python tests/torch_jax_flagship.py grads [--res 32] [--seed 0] [--target-n 16] [--no-fma]

curves: tools/inverse_flagship.py and plutracer_tpu_torch's
tools/inverse_flagship.py with the same flags on scenes/demo-box.urn
(other flags at their defaults), each in a subprocess on one CPU device,
their InverseRenderConfig's log_every set to 1 so that the curve has
every step. Prints both tools' loss, albedo MAE and emission error at
every step, and each tool's final albedo MAE with and without the
textured rows (true albedo 0: the texture, not mat_color, colours them,
so the image never sees those rows).

grads: the flagship's phase-1 loss (log space, n = 2, key `seed`) at the
tool's perturbed start (diffuse rows at 0.25, emission at a quarter),
against the port's render of the true scene at target n, and its
gradient to every differentiable field, in both packages: with every
pixel, then with the pixels whose radiance differs between the packages
by more than 1e-4 relative (the knife-edge lanes) weighted out.

--no-fma caps XLA's CPU ISA at SSE4.2, which has no FMA, so the JAX side
rounds products and sums apart as the port does; what still differs is
the packages' transcendental functions. tests/test_torch_flagship.py
holds the small cases of both.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parent.parent
DEMO = str(REPO / "scenes" / "demo-box.urn")

# the tool, its InverseRenderConfig made to log every step, then main(argv)
RUN_TOOL = """
import sys
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tools!r})
{import_tool}
config = tool.InverseRenderConfig
tool.InverseRenderConfig = lambda *a, **kw: config(*a, **dict(kw, log_every=1))
tool.main({argv!r})
"""


def xla_env(no_fma):
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    flags.append("--xla_cpu_multi_thread_eigen=false")
    if no_fma:
        flags.append("--xla_cpu_max_isa=SSE4_2")
    # one torch thread: torch's thread a core oversubscribes the host when
    # the two tools run side by side
    return dict(os.environ, JAX_PLATFORMS="cpu", PLUTRACER_NO_CACHE="1", OMP_NUM_THREADS="1",
                XLA_FLAGS=" ".join(flags))


def curves(args):
    flags = ["--scene", DEMO, "--res", str(args.res), "--steps", str(args.steps),
             "--phase2-steps", str(args.phase2_steps), "--target-n", str(args.target_n)]
    tools = {
        "jax": ("import inverse_flagship as tool", ["--platform", "cpu"]),
        "port": ("from plutracer_tpu_torch.tools import inverse_flagship as tool",
                 ["--device", "cpu"]),
    }
    with tempfile.TemporaryDirectory() as tmp:
        procs, outs = {}, {}
        for side, (import_tool, extra) in tools.items():
            outs[side] = pathlib.Path(tmp) / f"{side}.json"
            code = RUN_TOOL.format(repo=str(REPO), tools=str(REPO / "tools"),
                                   import_tool=import_tool,
                                   argv=flags + extra + ["--out", str(outs[side])])
            procs[side] = subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO),
                                           env=xla_env(args.no_fma), stdout=subprocess.DEVNULL,
                                           stderr=subprocess.PIPE, text=True)
        for side, proc in procs.items():
            _, err = proc.communicate()
            assert proc.returncode == 0, f"{side}: {err[-3000:]}"
        runs = {side: json.loads(out.read_text()) for side, out in outs.items()}
    j, p = runs["jax"], runs["port"]
    print(f"demo-box {args.res}x{args.res}, {args.steps} + {args.phase2_steps} steps"
          f"{', JAX without FMA' if args.no_fma else ''}")
    print("step | loss jax, port (relative difference) | albedo MAE jax, port | emission jax, port")
    for a, b in zip(j["curve"], p["curve"]):
        rel = abs(a["loss"] - b["loss"]) / abs(a["loss"])
        print(f"{a['step']:4d} | {a['loss']:.6g} {b['loss']:.6g} ({rel:.1e}) | "
              f"{a['albedo_mae']:.5f} {b['albedo_mae']:.5f} | "
              f"{a['emission_rel_err']:.5f} {b['emission_rel_err']:.5f}")
    import numpy as np

    for side, run in runs.items():
        true, got = np.asarray(run["true_albedo"]), np.asarray(run["recovered_albedo"])
        seen = ~(true == 0).all(-1)
        print(f"{side}: albedo MAE {run['init']['albedo_mae']:.4f} -> "
              f"{run['final']['albedo_mae']:.4f}; without the textured rows "
              f"{np.abs(0.25 - true)[seen].mean():.4f} -> {np.abs(got - true)[seen].mean():.4f}; "
              f"emission error {run['init']['emission_rel_err']:.4f} -> "
              f"{run['final']['emission_rel_err']:.4f}; recovered {np.round(got, 4).tolist()}")


def grads(args):
    os.environ.update(xla_env(args.no_fma))
    sys.path.insert(0, str(REPO))
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from plutracer_tpu.parallel.sharded import apply_params as jax_apply
    from plutracer_tpu.parallel.sharded import get_params as jax_get
    from plutracer_tpu.render.renderer import render as jax_render
    from plutracer_tpu.scene import compile_scene as jax_compile
    from plutracer_tpu.scene import load_scene_file as jax_load
    from plutracer_tpu_torch import rng
    from plutracer_tpu_torch.parallel.sharded import apply_params, params_from_numpy
    from plutracer_tpu_torch.render.renderer import render
    from plutracer_tpu_torch.scene import compile_scene, load_scene_file

    W = H = args.res
    js = jax_compile(jax_load(DEMO, ["/res", f"{W}x{H}"]))
    ts = compile_scene(load_scene_file(DEMO, ["/res", f"{W}x{H}"]), device="cpu")
    start = {k: np.asarray(v).copy() for k, v in jax_get(js).items()}
    start["mat_color"][np.asarray(js.mat_type) == 0] = 0.25
    start["light_intensity"] = start["light_intensity"] * 0.25
    target = render(ts, W, H, args.target_n, rng.PRNGKey(100)).numpy()
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    a = np.asarray(jax_render(jax_apply(js, jp), W, H, 2, jax.random.PRNGKey(args.seed)))
    b = render(apply_params(ts, params_from_numpy(start)), W, H, 2,
               rng.PRNGKey(args.seed)).numpy()
    rel = np.abs(a - b).max(-1) / np.maximum(np.abs(a).max(-1), 1e-6)
    edges = rel > 1e-4
    worst = np.argsort(-rel.ravel())[:5]
    print(f"demo-box {W}x{H}, n = 2, key {args.seed}, target n = {args.target_n}"
          f"{', JAX without FMA' if args.no_fma else ''}: {int(edges.sum())} of {W * H} pixels "
          f"differ by more than 1e-4 relative; the largest (JAX / port): "
          + ", ".join(f"{a.reshape(-1, 3)[i].max():.3g} / {b.reshape(-1, 3)[i].max():.3g}"
                      for i in worst))
    for what, weight in (("every pixel", np.ones((H, W, 1), np.float32)),
                         ("knife edges weighted out", (~edges).astype(np.float32)[..., None])):
        def jax_loss(p):
            x = jax_render(jax_apply(js, p), W, H, 2, jax.random.PRNGKey(args.seed))
            return jnp.mean(weight * (jnp.log1p(jnp.maximum(x, 0.0)) - jnp.log1p(target)) ** 2)

        jl, jg = jax.value_and_grad(jax_loss)(jp)
        tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in start.items()}
        x = render(apply_params(ts, tp), W, H, 2, rng.PRNGKey(args.seed))
        tl = torch.mean(torch.from_numpy(weight) * (torch.log1p(torch.clamp(x, min=0.0))
                                                    - torch.log1p(torch.from_numpy(target))) ** 2)
        tl.backward()
        print(f"{what}: loss JAX {float(jl):.7g}, port {tl.item():.7g} "
              f"(relative difference {abs(tl.item() - float(jl)) / float(jl):.2e})")
        for f, g in jg.items():
            g = np.asarray(g)
            scale = float(np.abs(g).max())
            diff = float(np.abs(tp[f].grad.numpy() - g).max())
            print(f"  {f}: largest |JAX| {scale:.4e}, largest |port - JAX| {diff:.3e} "
                  f"({diff / max(scale, 1e-30):.2e} of it)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("curves", "grads"))
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--phase2-steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--target-n", type=int, default=16)
    ap.add_argument("--no-fma", action="store_true")
    args = ap.parse_args()
    (curves if args.what == "curves" else grads)(args)


if __name__ == "__main__":
    main()
