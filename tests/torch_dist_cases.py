"""Shared harness of tests/test_torch_distributed{,_2dgs}.py: the port's
distributed rendering (gsplat_tpu_torch/distributed.py) in 4 gloo ranks on
the CPU against gsplat_tpu.distributed on a 4-device CPU mesh.

Every case is a spec in CASES. Its inputs come from numpy with a seed, at
tests/test_distributed.py's sizes. The port's side runs every case of both
files in one spawn of 4 rank processes (``python tests/torch_dist_cases.py
--rank r ...``, one intra-op thread each), once per test session, started
in the background as a test module is collected (`start_references`,
tests/torch_prefetch.py); every test reads the one result. Each rank runs
the case on its own shard and returns its blocks, meta and, for the
gradient cases, its rows of the gradients of ``sum(render * wr) +
sum(alphas)`` (2DGS: ``+ sum(normals * wn) + sum(distort)``, ``+ sum(nfd *
wf)`` where there are normals from depth), each rank summing over its own
block. The JAX side builds each case's reference once per process
(functools.lru_cache), jitted, the binned and tiled backends in interpret
mode.
"""

from __future__ import annotations

import argparse
import functools
import os
import pickle
import socket
import subprocess
import sys
import time
import traceback
import zlib

import numpy as np

import torch_prefetch as prefetch

N_RANKS = 4
SPAWN_TIMEOUT_S = 600
_DIR = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_DIR)
_CAP = 32768


def _case(dim, C, N, W, H, backend="oracle", grad=False, **kw):
    return dict(dim=dim, C=C, N=N, W=W, H=H, backend=backend, grad=grad, **kw)


# name -> spec. Keys past the scene's: render_mode, bg (backgrounds),
# colors ("rgb", "sh3" or "percam"), masks, carrier ("absgrad" or
# "densify"), antialiased, packed (pack_capacity), sparse (the packed
# compaction scene), dispatch (through rasterization{,_2dgs}), depth_mode,
# distloss, ts (tile size), cover (a factor on the scales: surfels cover
# every pixel, so no normal from depth is of a zero vector, whose
# normalisation has a NaN gradient in JAX)
CASES_3DGS = {
    "oracle-C4-RGB+ED-bg": _case("3dgs", 4, 256, 48, 32, grad=True, render_mode="RGB+ED", bg=True),
    "binned-C4-bg": _case("3dgs", 4, 256, 48, 32, "binned", grad=True, bg=True),
    "tiled-C4-bg": _case("3dgs", 4, 256, 48, 32, "tiled", grad=True, bg=True),
    "binned-C8-two-cameras-a-rank": _case("3dgs", 8, 128, 32, 32, "binned", grad=True),
    "oracle-C4-sh3-antialiased-masks": _case("3dgs", 4, 128, 32, 32, grad=True, colors="sh3", antialiased=True,
                                             masks=True),
    "oracle-C4-percam-D-bg": _case("3dgs", 4, 128, 32, 32, grad=True, colors="percam", render_mode="D", bg=True),
    "binned-C4-absgrad-RGB+ED": _case("3dgs", 4, 128, 32, 32, "binned", grad=True, carrier="absgrad",
                                      render_mode="RGB+ED"),
    "tiled-C4-densify-carrier-ED-bg": _case("3dgs", 4, 128, 32, 32, "tiled", grad=True, carrier="densify",
                                            render_mode="ED", bg=True),
    "oracle-strips-C1-absgrad": _case("3dgs", 1, 256, 48, 56, grad=True, carrier="absgrad", bg=True),
    "binned-strips-C1-RGB+ED": _case("3dgs", 1, 256, 48, 56, "binned", grad=True, render_mode="RGB+ED", bg=True),
    "tiled-strips-C2-sh3": _case("3dgs", 2, 128, 32, 40, "tiled", grad=True, colors="sh3", masks=True),
    "packed-oracle-compaction": _case("3dgs", 4, 128, 32, 32, grad=True, packed=8, sparse=True, bg=True),
    "packed-binned-RGB+D-absgrad": _case("3dgs", 4, 256, 48, 32, "binned", grad=True, packed=64,
                                         render_mode="RGB+D", carrier="absgrad"),
    "packed-tiled-truncated": _case("3dgs", 4, 256, 48, 32, "tiled", packed=4),
    "dispatch-dense-binned": _case("3dgs", 4, 256, 48, 32, "binned", bg=True, dispatch=True),
    "dispatch-packed-oracle": _case("3dgs", 4, 128, 32, 32, packed=32, dispatch=True, colors="sh3"),
}

CASES_2DGS = {
    "oracle-C4-RGB+ED-distloss": _case("2dgs", 4, 128, 32, 32, grad=True, render_mode="RGB+ED", distloss=True),
    "binned-C4-RGB+ED-bg": _case("2dgs", 4, 128, 32, 32, "binned", grad=True, render_mode="RGB+ED", bg=True,
                                 distloss=True),
    "tiled-C4-RGB+D-median": _case("2dgs", 4, 128, 32, 32, "tiled", grad=True, render_mode="RGB+D",
                                   depth_mode="median", distloss=True),
    "oracle-C8-sh3-masks-densify": _case("2dgs", 8, 128, 32, 32, grad=True, colors="sh3", masks=True,
                                         carrier="densify"),
    "oracle-C4-percam-ED": _case("2dgs", 4, 128, 32, 24, grad=True, colors="percam", render_mode="ED"),
    "binned-strips-C1-RGB+ED": _case("2dgs", 1, 128, 40, 56, "binned", grad=True, render_mode="RGB+ED",
                                     distloss=True, ts=8, cover=2.0),
    "oracle-strips-C1-RGB+ED-densify": _case("2dgs", 1, 128, 32, 56, grad=True, render_mode="RGB+ED",
                                             distloss=True, carrier="densify", bg=True),
    "tiled-strips-C2-RGB+D-median": _case("2dgs", 2, 128, 32, 40, "tiled", grad=True, render_mode="RGB+D",
                                          depth_mode="median"),
    "packed-oracle-compaction": _case("2dgs", 4, 128, 32, 32, grad=True, packed=8, sparse=True,
                                      render_mode="RGB+ED", distloss=True, carrier="densify"),
    "packed-binned-truncated": _case("2dgs", 4, 128, 32, 32, "binned", packed=4, render_mode="RGB+ED"),
    "dispatch-dense-oracle": _case("2dgs", 4, 128, 32, 24, dispatch=True, render_mode="RGB+ED"),
    "dispatch-packed-binned": _case("2dgs", 4, 128, 32, 32, "binned", packed=32, dispatch=True,
                                    render_mode="RGB+D", bg=True),
}

CASES = {**{"3dgs/" + k: v for k, v in CASES_3DGS.items()}, **{"2dgs/" + k: v for k, v in CASES_2DGS.items()}}


def inputs(spec):
    """The global numpy inputs of a case (tests/test_distributed.py's scene;
    `sparse`: its _sparse_visibility_scene, each rank's rows past the 6th
    behind the cameras)."""
    rng = np.random.default_rng(zlib.crc32(repr(sorted(spec.items())).encode()))
    N, C, W, H = spec["N"], spec["C"], spec["W"], spec["H"]
    means = rng.standard_normal((N, 3)).astype(np.float32)
    quats = rng.standard_normal((N, 4)).astype(np.float32)
    scales = (rng.random((N, 3)) * 0.25 + 0.05).astype(np.float32) * spec.get("cover", 1.0)
    opac = rng.random((N,)).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    viewmats[:, 2, 3] = 4.0
    for c in range(C):
        viewmats[c, 0, 3] = 0.1 * c
    Ks = np.tile(np.array([[25.0, 0, W / 2], [0, 25.0, H / 2], [0, 0, 1]], np.float32), (C, 1, 1))
    if spec.get("sparse"):
        hidden = (np.arange(N) % (N // N_RANKS)) >= 6
        means[hidden, 2] = -10.0
    kind = spec.get("colors", "rgb")
    if kind == "sh3":
        colors = (rng.standard_normal((N, 16, 3)) * 0.3).astype(np.float32)
    elif kind == "percam":
        colors = rng.random((C, N, 3)).astype(np.float32)
    else:
        colors = rng.random((N, 3)).astype(np.float32)
    mode = spec.get("render_mode", "RGB")
    X = 1 if mode in ("D", "ED") else 3 + (1 if mode in ("RGB+D", "RGB+ED") else 0)
    out = dict(
        means=means, quats=quats, scales=scales, opacities=opac, colors=colors, viewmats=viewmats, Ks=Ks,
        bg=rng.random((C, 3)).astype(np.float32) if spec.get("bg") else None,
        masks=(rng.random(N) > 0.2) if spec.get("masks") else None,
        wr=rng.standard_normal((C, H, W, X)).astype(np.float32),
        wn=rng.standard_normal((C, H, W, 3)).astype(np.float32),
        wf=rng.standard_normal((C, H, W, 3)).astype(np.float32),
    )
    return out


def kwargs(spec):
    """Keyword arguments common to both packages (backgrounds, masks and
    carriers are passed apart)."""
    kw = dict(backend=spec["backend"], render_mode=spec.get("render_mode", "RGB"), tile_size=spec.get("ts", 16))
    if spec["backend"] != "oracle":
        kw["isect_capacity"] = _CAP
    if spec.get("colors") == "sh3":
        kw["sh_degree"] = 3
    if spec["dim"] == "3dgs":
        if spec.get("antialiased"):
            kw["rasterize_mode"] = "antialiased"
        if spec.get("carrier") == "absgrad":
            kw["absgrad"] = True
    else:
        kw["distloss"] = spec.get("distloss", False)
        kw["depth_mode"] = spec.get("depth_mode", "expected")
    return kw


def layout(spec):
    """Per rank: (camera slice, strip rows (y0, y1) or None)."""
    C, H, ts = spec["C"], spec["H"], spec.get("ts", 16)
    out = []
    for r in range(N_RANKS):
        if C % N_RANKS == 0:
            k = C // N_RANKS
            out.append((slice(r * k, (r + 1) * k), None))
        else:
            G = N_RANKS // C
            strip_h = -(-(-(-H // ts)) // G) * ts
            y0 = min((r % G) * strip_h, H)
            out.append((slice(r // G, r // G + 1), (y0, min(y0 + strip_h, H))))
    return out


def block(x, cams, rows):
    x = x[cams]
    return x if rows is None else x[:, rows[0]:rows[1]]


def assemble(blocks, spec):
    """The ranks' image blocks -> [C, H, W, X]."""
    lay = layout(spec)
    if lay[0][1] is None:
        return np.concatenate(blocks, axis=0)
    G = N_RANKS // spec["C"]
    return np.concatenate([np.concatenate(blocks[c * G:(c + 1) * G], axis=1) for c in range(spec["C"])], axis=0)


def image_names(spec):
    return ("render", "alphas") if spec["dim"] == "3dgs" else (
        "render", "alphas", "normals", "normals_from_depth", "distort", "median")


def grad_names(spec):
    names = ["means", "quats", "scales", "opacities", "colors"]
    if spec.get("carrier"):
        names.append("carrier")
    return names


# --- the port's side: one rank ----------------------------------------------


def _port_case(spec, rank, torch):
    from gsplat_tpu_torch import distributed as D, rendering

    g = inputs(spec)
    nl = spec["N"] // N_RANKS
    rows = slice(rank * nl, (rank + 1) * nl)
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    percam = spec.get("colors") == "percam"
    params = [t(g[k][rows]) for k in ("means", "quats", "scales", "opacities")]
    params.append(t(g["colors"][:, rows] if percam else g["colors"][rows]))
    if spec["grad"]:
        for p in params:
            p.requires_grad_(True)
    kw = kwargs(spec)
    kw["backgrounds"] = t(g["bg"])
    kw["masks"] = t(None if g["masks"] is None else g["masks"][rows])
    carrier = None
    if spec.get("carrier"):
        carrier = torch.zeros((spec["C"], nl, 2), requires_grad=True)
        kw["means2d_carrier" if spec["dim"] == "3dgs" else "densify_carrier"] = carrier
    args = params + [t(g["viewmats"]), t(g["Ks"]), spec["W"], spec["H"]]
    if spec["dim"] == "3dgs":
        direct = D.rasterization_distributed_packed if spec.get("packed") else D.rasterization_distributed
        api = rendering.rasterization
    else:
        direct = D.rasterization_2dgs_distributed_packed if spec.get("packed") else D.rasterization_2dgs_distributed
        api = rendering.rasterization_2dgs
    dkw = dict(kw)
    if spec.get("packed"):
        dkw["pack_capacity"] = spec["packed"]
    elif percam:
        dkw["per_camera_colors"] = True
    out = direct(*args, **dkw)
    res = {}
    if spec.get("dispatch"):
        via = api(*args, distributed=True, packed=bool(spec.get("packed")), pack_capacity=spec.get("packed"), **kw)
        res["dispatch_equal"] = all(
            (a is None and b is None) or torch.equal(a, b) for a, b in zip(via[:-1], out[:-1])
        ) and sorted(via[-1]) == sorted(out[-1])
    images, meta = out[:-1], out[-1]
    cams, strip = layout(spec)[rank]
    if spec["grad"]:
        loss = (images[0] * t(block(g["wr"], cams, strip))).sum() + images[1].sum()
        if spec["dim"] == "2dgs":
            loss = loss + (images[2] * t(block(g["wn"], cams, strip))).sum() + images[4].sum()
            if images[3] is not None:
                loss = loss + (images[3] * t(block(g["wf"], cams, strip))).sum()
        loss.backward()
        # an input the loss does not read (colours in a depth mode) has none
        res["grads"] = [np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
                        for p in params + ([carrier] if carrier is not None else [])]
    res["images"] = [None if x is None else x.detach().numpy() for x in images]
    res["meta"] = {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v) for k, v in meta.items()}
    return res


# cases rendered again at world size 1, against the single-device call
WORLD1 = ("3dgs/binned-C4-bg", "3dgs/tiled-C4-bg", "2dgs/binned-C4-RGB+ED-bg")


def _world1_case(spec, group, torch):
    """The whole case in a one-rank group and through the single-device
    rasterization{,_2dgs}: whether every output and gradient is the same
    bits (the exchange keeps the global Gaussian order)."""
    from gsplat_tpu_torch import distributed as D, rendering

    g = inputs(spec)
    kw = kwargs(spec)
    kw["backgrounds"] = None if g["bg"] is None else torch.from_numpy(g["bg"])
    outs, grads = [], []
    for fn in ("distributed", "single"):
        ps = [torch.tensor(g[k], requires_grad=True) for k in ("means", "quats", "scales", "opacities", "colors")]
        args = ps + [torch.from_numpy(g["viewmats"]), torch.from_numpy(g["Ks"]), spec["W"], spec["H"]]
        if spec["dim"] == "3dgs":
            out = (D.rasterization_distributed(*args, group=group, **kw) if fn == "distributed"
                   else rendering.rasterization(*args, **kw))
        else:
            out = (D.rasterization_2dgs_distributed(*args, group=group, **kw) if fn == "distributed"
                   else rendering.rasterization_2dgs(*args, **kw))
        (out[0] * torch.from_numpy(g["wr"])).sum().backward()
        outs.append([x for x in out[:-1] if x is not None])
        grads.append([p.grad for p in ps])
    pairs = list(zip(outs[0], outs[1])) + list(zip(grads[0], grads[1]))
    return {"equal": all(torch.equal(a, b) for a, b in pairs),
            "max_abs": max(float((a - b).abs().max()) for a, b in pairs)}


def rank_main(rank, port, out_path):
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    import datetime

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=N_RANKS, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    results = {}
    name = None
    try:
        for name, spec in CASES.items():
            t0 = time.perf_counter()
            results[name] = _port_case(spec, rank, torch)
            results[name]["seconds"] = time.perf_counter() - t0
        # a group of one rank each: the distributed path at world size 1
        groups = [dist.new_group([r]) for r in range(N_RANKS)]
        for name in WORLD1:
            results["world1/" + name] = _world1_case(CASES[name], groups[rank], torch)
    except Exception:
        results["__error__"] = f"rank {rank}, case {name}:\n{traceback.format_exc()}"
    with open(out_path, "wb") as f:
        pickle.dump(results, f)
    if "__error__" not in results:
        dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(script, argv, out_dir):
    """Run ``python tests/<script> --rank r *argv --out <out_dir>/rank<r>.pkl``
    in N_RANKS processes of one intra-op thread each, outside any launcher's
    rank environment, and return each rank's pickled results in rank order,
    or {"__error__": ...} when a rank wrote none or reported one."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    paths = [os.path.join(out_dir, f"rank{r}.pkl") for r in range(N_RANKS)]
    procs = [
        subprocess.Popen([sys.executable, os.path.join(_DIR, script), "--rank", str(r), *argv, "--out", paths[r]],
                         cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(N_RANKS)
    ]
    logs = []
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        logs.append(out.decode(errors="replace")[-4000:])
    per_rank = []
    for r, path in enumerate(paths):
        if not os.path.exists(path):
            return {"__error__": f"rank {r} wrote no results (rc {procs[r].returncode}):\n{logs[r]}"}
        with open(path, "rb") as f:
            per_rank.append(pickle.load(f))
    errors = [pr["__error__"] for pr in per_rank if "__error__" in pr]
    if errors:
        return {"__error__": "\n".join(errors)}
    return per_rank


def _spawn(out_dir):
    per_rank = spawn_ranks("torch_dist_cases.py", ["--port", str(free_port())], out_dir)
    if isinstance(per_rank, dict):
        return per_rank
    return {name: [pr[name] for pr in per_rank] for name in list(CASES) + ["world1/" + n for n in WORLD1]}


def start_references():
    """Start the session's 4-rank spawn in the background
    (tests/torch_prefetch.py), when a test module is collected."""
    prefetch.start("torch_dist", [os.path.abspath(__file__), "--session-spawn"])


def port_results():
    """{case: [rank 0's result, ...]}, from the one spawn of the session."""
    return prefetch.result("torch_dist")


# --- the JAX side ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_result(name):
    """gsplat_tpu.distributed on the first 4 CPU devices: (images, meta,
    grads or None), global arrays."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from gsplat_tpu import distributed as D

    spec = CASES[name]
    g = inputs(spec)
    mesh = Mesh(np.array(jax.devices()[:N_RANKS]), ("gauss",))
    percam = spec.get("colors") == "percam"
    shard = lambda a, s: jax.device_put(jnp.asarray(a), NamedSharding(mesh, s))  # noqa: E731
    params = [shard(g[k], P("gauss")) for k in ("means", "quats", "scales", "opacities")]
    params.append(shard(g["colors"], P(None, "gauss") if percam else P("gauss")))
    kw = kwargs(spec)
    if g["bg"] is not None:
        kw["backgrounds"] = jnp.asarray(g["bg"])
    if g["masks"] is not None:
        kw["masks"] = shard(g["masks"], P("gauss"))
    carrier_kw = None
    if spec.get("carrier"):
        params.append(shard(np.zeros((spec["C"], spec["N"], 2), np.float32), P(None, "gauss", None)))
        carrier_kw = "means2d_carrier" if spec["dim"] == "3dgs" else "densify_carrier"
    vm, K = jnp.asarray(g["viewmats"]), jnp.asarray(g["Ks"])
    W, H = spec["W"], spec["H"]
    if spec["dim"] == "3dgs":
        fn = D.rasterization_distributed_packed if spec.get("packed") else D.rasterization_distributed
    else:
        fn = D.rasterization_2dgs_distributed_packed if spec.get("packed") else D.rasterization_2dgs_distributed
    if spec.get("packed"):
        kw["pack_capacity"] = spec["packed"]
    elif percam:
        kw["per_camera_colors"] = True

    def run(*ps):
        extra = {carrier_kw: ps[5]} if carrier_kw else {}
        out = fn(*ps[:5], vm, K, W, H, mesh=mesh, **kw, **extra)
        images, meta = out[:-1], out[-1]
        loss = jnp.sum(images[0] * g["wr"]) + jnp.sum(images[1])
        if spec["dim"] == "2dgs":
            loss = loss + jnp.sum(images[2] * g["wn"]) + jnp.sum(images[4])
            if images[3] is not None:
                loss = loss + jnp.sum(images[3] * g["wf"])
        return loss, (images, meta)

    if spec["grad"]:
        (_, (images, meta)), grads = jax.jit(
            jax.value_and_grad(run, argnums=tuple(range(len(params))), has_aux=True))(*params)
        grads = [np.asarray(x) for x in grads]
    else:
        _, (images, meta) = jax.jit(run)(*params)
        grads = None
    images = [None if x is None else np.asarray(x) for x in images]
    meta = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in meta.items()}
    return images, meta, grads


# JAX's own tolerances (tests/test_distributed.py:77-78, 120-123, 196-205):
# name -> (atol, rtol). The 3DGS cases hold to them; 2DGS holds to them on
# the oracle with whole cameras, at the port's own port-vs-JAX oracle atol
# (tests/test_torch_rendering_2dgs.py: 1e-4 for every output, JAX's 5e-4
# for the normals from depth)
TOL_3DGS = {"render": (2e-5, 1e-5), "alphas": (2e-5, 1e-5)}
TOL_2DGS = {"render": (1e-4, 1e-5), "alphas": (1e-4, 1e-5), "normals": (1e-4, 1e-5),
            "normals_from_depth": (5e-4, 1e-4), "distort": (1e-4, 1e-5), "median": (1e-4, 1e-5)}
GRAD_ATOL, GRAD_RTOL = 2e-4, 2e-4  # atol x max(|g|, 1)


def flip_gated(spec):
    """2DGS on the binned and tiled backends, and in the strip layout on any
    backend, is held by tests/test_torch_rendering_2dgs.py's count gates:
    the port's and JAX's 2DGS kernels differ by f32 flips of borderline
    acceptances at one device already, and a strip's shift of the ray
    transform (M[1] - y_off * M[2]) rounds its surfel sigma otherwise than
    the unshifted one, in either package (JAX's own strips differ from its
    single device about as much as the port's strips from the port's)."""
    return spec["dim"] == "2dgs" and (spec["backend"] != "oracle" or spec["C"] % N_RANKS != 0)


def flip_gate(got, want, what, share=True):
    d = np.abs(got - want)
    assert d.max() < 5e-2, f"{what} max {d.max():.2e}"
    if share:
        assert (d > 5e-4).mean() < 1e-3, f"{what} flips {(d > 5e-4).mean():.2%}"


def grad_gate(name, i, got, want):
    """tests/test_torch_rendering_2dgs.py's port-vs-JAX 2DGS gradient gate
    (a share <= 5e-3 of values off by more than 1e-3 x |value| + 1e-3 x
    max(1, the largest |value|), none by more than 0.05 x that), against
    JAX's distributed gradient. Where more are off, each value past the
    gate must be explained: by JAX's single-device gradient, which the
    port's lies within the gate of (JAX's distributed program rounds
    otherwise), or by a single-device flip of the 2DGS kernels (the port's
    single-device gradient as far from JAX's, and the port's distributed
    one within the gate of it)."""
    what = f"{name} grad {grad_names(CASES[name])[i]}"
    s = max(float(np.abs(want).max()), 1.0)
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    d = np.abs(got - want)
    assert d.max() <= 0.05 * s, f"{what}: max abs {d.max():.3e} against scale {s:.3e}"
    within = lambda a, w: np.abs(a - w) <= 1e-3 * np.abs(w) + 1e-3 * s  # noqa: E731
    off = ~within(got, want)
    if off.mean() > 5e-3:
        js, ps = jax_single_grads(name)[i], port_single_grads(name)[i]
        off &= ~(within(got, js) | (~within(ps, js) & within(got, ps)))
    assert off.mean() <= 5e-3, f"{what}: {off.sum()} of {off.size} values off, max abs {d.max():.3e}"


def _single_loss(spec, g, out, xp):
    loss = xp.sum(out[0] * g["wr"]) + xp.sum(out[1]) + xp.sum(out[2] * g["wn"]) + xp.sum(out[4])
    if out[3] is not None:
        loss = loss + xp.sum(out[3] * g["wf"])
    return loss


def _single_kwargs(spec, g, conv):
    kw = kwargs(spec)
    if spec["backend"] != "oracle":
        kw["isect_capacity"] = _CAP * N_RANKS
    for k, key in (("backgrounds", "bg"), ("masks", "masks")):
        if g[key] is not None:
            kw[k] = conv(g[key])
    return kw


@functools.lru_cache(maxsize=None)
def jax_single_grads(name):
    """JAX's single-device rasterization_2dgs gradients of the case's loss."""
    import jax
    import jax.numpy as jnp

    from gsplat_tpu.rendering import rasterization_2dgs

    spec = CASES[name]
    g = inputs(spec)
    kw = _single_kwargs(spec, g, jnp.asarray)
    n_args = 6 if spec.get("carrier") else 5

    def loss(*ps):
        extra = {"densify_carrier": ps[5]} if n_args == 6 else {}
        out = rasterization_2dgs(*ps[:5], jnp.asarray(g["viewmats"]), jnp.asarray(g["Ks"]), spec["W"], spec["H"],
                                 **kw, **extra)
        return _single_loss(spec, g, out, jnp)

    args = [jnp.asarray(g[k]) for k in ("means", "quats", "scales", "opacities", "colors")]
    args += [jnp.zeros((spec["C"], spec["N"], 2), jnp.float32)] if n_args == 6 else []
    return [np.asarray(x) for x in jax.jit(jax.grad(loss, argnums=tuple(range(n_args))))(*args)]


@functools.lru_cache(maxsize=None)
def port_single_grads(name):
    """The port's single-device rasterization_2dgs gradients of the case's
    loss (CPU, the kernels' plain versions)."""
    import torch

    from gsplat_tpu_torch.rendering import rasterization_2dgs

    spec = CASES[name]
    g = inputs(spec)
    ps = [torch.tensor(g[k], requires_grad=True) for k in ("means", "quats", "scales", "opacities", "colors")]
    extra = {}
    if spec.get("carrier"):
        ps.append(torch.zeros((spec["C"], spec["N"], 2), requires_grad=True))
        extra["densify_carrier"] = ps[-1]
    out = rasterization_2dgs(*ps[:5], torch.from_numpy(g["viewmats"]), torch.from_numpy(g["Ks"]), spec["W"],
                             spec["H"], **_single_kwargs(spec, g, torch.from_numpy), **extra)
    g_t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in g.items()}
    _single_loss(spec, g_t, out, torch).backward()
    return [np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy() for p in ps]


def assembled(name, ranks, i):
    return assemble([r["images"][i] for r in ranks], CASES[name])


def compare_values(name, ranks):
    """The ranks' blocks assembled, their radii and meta against JAX's."""
    spec = CASES[name]
    images, meta, _ = jax_result(name)
    tol = TOL_3DGS if spec["dim"] == "3dgs" else TOL_2DGS
    for i, key in enumerate(image_names(spec)):
        if images[i] is None:
            assert all(r["images"][i] is None for r in ranks), key
            continue
        got = assembled(name, ranks, i)
        assert got.shape == images[i].shape, (key, got.shape, images[i].shape)
        assert np.isfinite(got).all(), key
        if flip_gated(spec):
            # the normals from depth difference the depth of neighbouring
            # pixels, which doubles a flip's reach: their values are held
            # to the port's own depth by `compare_normals_from_depth`
            flip_gate(got, images[i], f"{name} {key}", share=key != "normals_from_depth")
        else:
            atol, rtol = tol[key]
            np.testing.assert_allclose(got, images[i], atol=atol, rtol=rtol, err_msg=f"{name} {key}")
    metas = [r["meta"] for r in ranks]
    assert all(sorted(m) == sorted(meta) for m in metas), (sorted(metas[0]), sorted(meta))
    np.testing.assert_array_equal(np.concatenate([m["radii"] for m in metas], axis=1), meta["radii"])
    for key, want in meta.items():
        if key == "radii":
            continue
        for m in metas:
            np.testing.assert_array_equal(np.asarray(m[key]), np.asarray(want), err_msg=f"{name} meta {key}")


def compare_normals_from_depth(name, ranks):
    """The ranks' normals from depth, assembled, against `depth_to_normal`
    of the assembled depth on one device: a strip's first and last rows
    read its neighbours' depth rows, and only the image's border rows are
    zero. Returns the rows at strip boundaries (for the caller's report)."""
    import torch

    from gsplat_tpu_torch.utils import depth_to_normal

    spec = CASES[name]
    g = inputs(spec)
    render, median, nfd = (assembled(name, ranks, i) for i in (0, 5, 3))
    depth = render[..., -1:] if spec.get("depth_mode", "expected") == "expected" else median
    want = depth_to_normal(torch.from_numpy(depth), torch.linalg.inv(torch.from_numpy(g["viewmats"])),
                           torch.from_numpy(g["Ks"])).numpy()
    np.testing.assert_allclose(nfd, want, atol=1e-6, rtol=0, err_msg=f"{name} normals from depth")
    rows = sorted({y for _, strip in layout(spec) if strip for y in strip if 0 < y < spec["H"]}
                  | {y - 1 for _, strip in layout(spec) if strip for y in strip if 0 < y < spec["H"]})
    return rows, nfd, want


def compare_grads(name, ranks):
    """The ranks' gradient rows, assembled in rank order, against JAX's
    global gradients."""
    spec = CASES[name]
    _, _, grads = jax_result(name)
    for i, key in enumerate(grad_names(spec)):
        axis = 1 if key == "carrier" or (key == "colors" and spec.get("colors") == "percam") else 0
        got = np.concatenate([r["grads"][i] for r in ranks], axis=axis)
        want = grads[i]
        if spec["dim"] == "2dgs":
            grad_gate(name, i, got, want)
        else:
            s = max(float(np.abs(want).max()), 1.0)
            np.testing.assert_allclose(got, want, atol=GRAD_ATOL * s, rtol=GRAD_RTOL, err_msg=f"{name} grad {key}")


if __name__ == "__main__" and sys.argv[1:2] == ["--session-spawn"]:
    work = os.path.join(prefetch.shared_dir(), "torch_dist_ranks")
    os.makedirs(work, exist_ok=True)
    prefetch.write(sys.argv[sys.argv.index("--out") + 1], _spawn(work))
elif __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    rank_main(a.rank, a.port, a.out)
