"""Dry run: every (arch × input shape × mesh) walked on meta tensors.

The port of ``repro.launch.dryrun``: the no-hardware check of whether an
arch at an input shape fits a device, with one step's flops, bytes and
roofline. The reference lowers and compiles each step on a mesh of
placeholder devices and reads XLA's memory and cost analyses; here each
step runs once on the meta device (``launch.cost_analysis.walk``: shapes,
no storage) under the activation policy of its mesh. Unlike the
reference, this module sets no ``XLA_FLAGS`` and no device count: the walk
needs no devices.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch all --shape all --mesh one --variant flash --out results/torch_dryrun

Steps per shape kind (see launch/steps.py):
  train_4k               analytic_train_step  (forward + Gram update; the
                         paper's gradient-free local stage — no backward)
  prefill_32k            prefill_step
  decode_32k, long_500k  serve_step (1 new token against a full-length
                         cache, at the cache's last position)

Meshes (``--mesh``):
  one     the port's deployment, one H100 (``mesh.make_host_mesh``); no
          collectives
  single  (16, 16), multi (2, 16, 16): the reference's production meshes.
          The step runs as a partitioned step: its params, batch, state or
          cache are DTensors under ``launch.sharding``'s rules on a fake
          process group at the mesh's sizes (``mesh.fake_device_mesh``),
          and the walk follows rank 0's local ops, so flops, bytes,
          temporaries and collectives (bytes by kind, their count and
          total, each element at most 2 bytes for a bf16 model, as the
          reference caps them) are one device's. The flash variant adds
          ``attention_flops / chips``, as the reference does.

Variants (``--variant``, default "baseline"):
  baseline    attention through the plain ``sdpa_plain`` (its logits and
              softmax counted, as the reference's baseline lowers its
              plain ``sdpa``)
  flash       attention as the flash kernel: the surrogate of
              ``layers.sdpa`` (its boundary bytes) and the kernel's flops
              (``attention_flops``) added; on the card attention is
              always the kernel, so this is what the port runs
  ring        decode against a KV cache capped at the attention window
  gradfl      train shapes walk the gradient-FL baseline's local step
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core import act, streaming
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.inputs import input_specs
from repro_torch.models import transformer as T

# long_500k policy, the reference's: native sub-quadratic archs run as-is;
# dense/moe/vlm run an explicit sliding-window variant; seamless (enc-dec)
# is the one documented skip.
LONG_WINDOW = 4096
LONG_NATIVE = {"zamba2_7b", "xlstm_350m"}
LONG_SKIP = {"seamless_m4t_medium"}
MESHES = ("one", "single", "multi")


def resolve_config(arch: str, shape: InputShape, variant: str) -> Optional[ModelConfig]:
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")  # the reference's target dtype
    if "pad" in variant:
        # head padding: round head counts up to the TP width (the
        # reference's §Perf variant; exact for frozen backbones when the
        # padded heads' wo rows are zero)
        tp = 16
        pad = lambda h: -(-h // tp) * tp if h % tp else h  # noqa: E731
        cfg = dataclasses.replace(
            cfg, num_heads=pad(cfg.num_heads), num_kv_heads=pad(cfg.num_kv_heads),
            head_dim=cfg.resolved_head_dim)
    if shape.name == "long_500k":
        if arch in LONG_SKIP:
            return None
        if arch not in LONG_NATIVE:
            # every layer windowed (gemma3's global layers included)
            cfg = dataclasses.replace(cfg, window=LONG_WINDOW, global_every=0)
    return cfg


def attention_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Analytic flops (global) of every attention instance — the work the
    flash kernel does when the ``flash`` variant stands it in.

    4·B·H·Sq·Skv_eff·hd per instance (QKᵀ + PV, 2 flops a MAC each); causal
    self-attention halves Skv_eff; sliding windows cap it at the window.
    """
    b, S = shape.global_batch, shape.seq_len
    hd, h = cfg.resolved_head_dim, cfg.num_heads
    decode = shape.kind == "decode"
    sq = 1 if decode else S

    def inst(skv, *, causal=True, window=0) -> float:
        eff = float(skv)
        if causal and not decode and sq == skv:
            eff = eff / 2.0
        if window and window < eff:
            eff = float(window)
        return 4.0 * b * h * sq * eff * hd

    total = 0.0
    if cfg.arch_type in ("dense", "moe"):
        windows = np.asarray(T.layer_meta(cfg, cfg.num_layers)[0])
        for w in windows:
            total += inst(S, window=int(w))
    elif cfg.arch_type == "hybrid":
        n_groups = cfg.num_layers // cfg.shared_attn_every
        for _ in range(n_groups):
            total += inst(S, window=cfg.window)
    elif cfg.arch_type == "encdec":
        enc_len = cfg.encoder_seq if decode else min(cfg.encoder_seq, S)
        total += cfg.num_layers * inst(S)                       # dec self
        total += cfg.num_layers * inst(enc_len, causal=False)   # cross
        if not decode:  # encoder runs in train/prefill only
            total += cfg.encoder_layers * (4.0 * b * h * enc_len * enc_len * hd)
    # xlstm: no attention
    return total


def build_step(cfg: ModelConfig, shape: InputShape, variant: str = "flash", *,
               device="meta", use_kernel: bool = True, params=None):
    """(fn, args, static) of one step of ``cfg`` at ``shape``: ``fn(*args)``
    is the step, its arguments tensors on ``device`` (meta: no storage; on
    another device the batch is zeros and ``params``, when not given, a
    seeded draw), and ``static`` their trees by name (params, batch, state
    or cache; prefill's cache, on meta, is the one the step makes) for the
    static bytes."""
    if params is None:
        params = T.init_params(cfg, device=device)
    batch = input_specs(cfg, shape, dtype=cfg.param_dtype)
    if device != "meta":
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                 for k, v in batch.items()}
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if variant == "gradfl":
            head = torch.zeros((cfg.d_model, cfg.num_classes), dtype=torch.float32,
                               device=device)
            step = ST.make_fedavg_train_step(cfg)
            return step, (params, head, batch), {"params": params, "batch": batch}
        state = streaming.init_state(cfg.d_model, cfg.num_classes, device=device)
        step = ST.make_analytic_train_step(cfg, use_kernel=use_kernel)
        return step, (params, state, batch), {"params": params, "batch": batch,
                                              "state": state}
    if shape.kind == "prefill":
        step = ST.make_prefill_step(cfg, s)
        cache = T.init_cache(cfg, b, s, device="meta")
        return step, (params, batch), {"params": params, "batch": batch, "cache": cache}
    cache_len = s
    if "ring" in variant and cfg.window:
        cache_len = min(cache_len, cfg.window)
    cache = T.init_cache(cfg, b, cache_len, device=device)
    step = ST.make_serve_step(cfg)
    # a meta tensor has no value: the walk's position is the cache's last slot
    return step, (params, cache, batch["token"], cache_len - 1), {
        "params": params, "cache": cache, "batch": {"token": batch["token"]}}


def _static_specs(cfg, shape, static: dict, mesh) -> dict:
    rules = {"params": lambda t: SH.param_specs(t, mesh),
             "batch": lambda t: SH.batch_specs(cfg, t, mesh),
             "state": lambda t: SH.state_specs(mesh),
             "cache": lambda t: SH.cache_specs(cfg, t, shape, mesh)}
    return {k: rules[k](v) for k, v in static.items()}


def distribute_step(cfg: ModelConfig, shape: InputShape, args: tuple, device_mesh) -> tuple:
    """A step's arguments (``build_step``'s) as DTensors on ``device_mesh``
    under ``launch.sharding``'s rules: params, then the batch, the state or
    the cache and token by the step's kind; plain ints stay."""
    params = SH.distribute(args[0], SH.param_shardings(args[0], device_mesh), device_mesh)
    batch_of = lambda t: SH.distribute(  # noqa: E731
        t, SH.batch_shardings(cfg, t, device_mesh), device_mesh)
    if shape.kind == "train":
        second = args[1]
        if isinstance(second, streaming.AnalyticState):
            second = SH.distribute(second, SH.state_shardings(device_mesh), device_mesh)
        else:  # gradfl's head: replicated
            second = SH.distribute(second, act.to_placements((), device_mesh), device_mesh)
        return params, second, batch_of(args[2])
    if shape.kind == "prefill":
        return params, batch_of(args[1])
    cache = SH.distribute(args[1], SH.cache_shardings(cfg, args[1], shape, device_mesh),
                          device_mesh)
    token = batch_of({"token": args[2]})["token"]
    return params, cache, token, args[3]


def step_cost(cfg: ModelConfig, shape: InputShape, variant: str = "flash",
              mesh=None, *, use_kernel: bool = True) -> dict:
    """Walk one step of ``cfg`` at ``shape`` on meta tensors under ``mesh``'s
    policy (the host mesh by default) → {"cost": Cost of the step on one
    device, "attn_flops": the kernel's global flops (flash variant, else
    0), "static": per-device bytes by name under the mesh's rules}. On a
    mesh of more than one chip the step is partitioned, its arguments
    DTensors on a fake process group at the mesh's sizes, and the cost is
    rank 0's, collectives included. The cost's flops include
    ``attn_flops / chips``."""
    mesh = mesh or M.make_host_mesh()
    chips = M.num_chips(mesh)
    fn, args, static = build_step(cfg, shape, variant, use_kernel=use_kernel)
    specs = _static_specs(cfg, shape, static, mesh)
    static_bytes = {k: SH.sharded_bytes(v, specs[k], mesh) for k, v in static.items()}
    cap = 2 if cfg.param_dtype == torch.bfloat16 else 0
    place = lambda a: a  # noqa: E731
    policy_mesh = mesh
    if chips > 1:
        policy_mesh = M.fake_device_mesh(mesh)
        place = lambda a: distribute_step(cfg, shape, a, policy_mesh)  # noqa: E731
    with act.activation_policy(policy_mesh, M.batch_axes(mesh), M.model_axes(mesh),
                               flash_surrogate=variant.startswith("flash")):
        cost = CA.walk(fn, *place(args), width_cap=cap, chips=chips)[0]
    attn = attention_flops(cfg, shape) if variant.startswith("flash") else 0.0
    cost.flops += int(attn / chips)
    return {"cost": cost, "attn_flops": attn, "static": static_bytes}


def run_one(arch: str, shape_name: str, mesh_name: str, variant: str) -> dict:
    shape = INPUT_SHAPES[shape_name]
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "variant": variant, "ok": False}
    cfg = resolve_config(arch, shape, variant)
    if cfg is None:
        rec["skipped"] = "long_500k inapplicable (see DESIGN.md §Arch-applicability)"
        return rec
    mesh = (M.make_host_mesh() if mesh_name == "one"
            else M.make_production_mesh(multi_pod=mesh_name == "multi"))
    chips = M.num_chips(mesh)
    t0 = time.perf_counter()
    try:
        out = step_cost(cfg, shape, variant, mesh)
    except Exception as e:  # a failure here is a bug of the walk: record it
        rec["error"] = f"{type(e).__name__}: {e}"
        return rec
    cost = out["cost"]
    static = out["static"]
    temp = cost.temp_bytes
    peak = sum(static.values()) + temp
    coll = dict(cost.collective_bytes, count=cost.collective_count,
                total=cost.collective_total)
    rec.update(
        ok=True,
        chips=chips,
        walk_s=round(time.perf_counter() - t0, 2),
        walk_ops=cost.ops,
        flops_per_device=cost.flops,
        bytes_per_device=cost.bytes_accessed,
        attn_flops_global=out["attn_flops"],
        flops_global=cost.flops * chips,
        bytes_global=cost.bytes_accessed * chips,
        replicated_flops=cost.replicated,
        collectives=coll,
        memory=dict(
            static_bytes_per_device=static,
            temp_bytes_per_device=temp,
            peak_bytes_per_device=peak,
            peak_aval_bytes=cost.peak_aval_bytes,
            peak_aval_shape=cost.peak_aval_shape,
            hbm_bytes=M.HBM_BYTES,
            fits=peak <= M.HBM_BYTES,
        ),
        roofline=M.Roofline(flops=cost.flops * chips, hbm_bytes=cost.bytes_accessed * chips,
                            collective_bytes=cost.collective_total * chips, chips=chips,
                            dtype=cfg.param_dtype).as_dict(),
    )
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all", choices=["all", *INPUT_SHAPES.keys()])
    ap.add_argument("--mesh", default="one", choices=[*MESHES, "all"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="results/torch_dryrun")
    ap.add_argument("--here", action="store_true",
                    help="walk a pod mesh in this process (its fake process group "
                         "stays up until the process ends)")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = MESHES if args.mesh == "all" else (args.mesh,)
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    n_fail = 0
    here = [m for m in meshes if m == "one" or args.here]
    for mesh_name in meshes:
        if mesh_name in here:
            continue
        # a pod mesh's fake process group in a process of its own
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", args.arch,
               "--shape", args.shape, "--mesh", mesh_name, "--variant", args.variant,
               "--out", str(outdir), "--here"]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                                  p for p in (str(pathlib.Path(__file__).parents[2]),
                                              os.environ.get("PYTHONPATH")) if p)))
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            n_fail += 1
            print(f"[FAIL] mesh {mesh_name}: {proc.stderr[-2000:]}", flush=True)
    for arch in archs:
        for shape_name in shapes:
            for mesh_name in here:
                tag = f"{arch}__{shape_name}__{mesh_name}"
                if args.variant != "baseline":
                    tag += f"__{args.variant}"
                rec = run_one(arch, shape_name, mesh_name, args.variant)
                (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
                if rec.get("skipped"):
                    print(f"[skip] {tag}: {rec['skipped']}", flush=True)
                elif rec["ok"]:
                    r, m = rec["roofline"], rec["memory"]
                    coll = ("n/a" if r["collective_s"] is None
                            else f"{r['collective_s'] * 1e3:.2f}ms")
                    print(f"[ ok ] {tag}: walk={rec['walk_s']}s "
                          f"peak/dev={m['peak_bytes_per_device'] / 2**30:.2f}GiB "
                          f"({'fits' if m['fits'] else 'does not fit'} "
                          f"{m['hbm_bytes'] / 2**30:.2f}GiB) "
                          f"compute={r['compute_s'] * 1e3:.2f}ms "
                          f"memory={r['memory_s'] * 1e3:.2f}ms coll={coll} → {r['dominant']}",
                          flush=True)
                else:
                    n_fail += 1
                    print(f"[FAIL] {tag}: {rec.get('error')}", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} combination(s) failed")


if __name__ == "__main__":
    main()
