"""Serving launcher: batched prefill, then greedy decode against a KV cache.

The port of ``repro.launch.serve``. Its LLM-serving mode serves any
arch with its family's cache (KV for dense and moe, SSM / conv state and
the shared block's KV for hybrid, recurrent state for xLSTM, self and
cross-attention KV for enc-dec): a batch of prompts is prefilled in one
forward pass that fills the cache, then each decode step feeds the
previous step's greedy token at the next position. On the card every
attention call is the hand-written flash kernel
(``kernels/csrc/flash_attention.cu``).

``--federation`` serves an AFL federation instead: a ``FederationService``
over HTTP or the mux protocol (optionally TLS and a bearer token) hosting a
coordinator (``--coordinator sync|async|sharded``), with the durable
submit ledger, snapshots, and the warm-standby and read-only replica roles.
The sync and async kinds are host f64 and need no card; the sharded kind
(``--shards N``, ``--tiled`` for the row-tiled Gram) accumulates in host
f64 and solves over a shard mesh on ``--device`` (every visible card by
default; ``--device cpu`` for the CPU).

Usage (the card; ``--device cpu`` runs the plain versions on the CPU, and
``--reduced`` the smoke-test variant of the config; unlike the reference's
launcher, the default is the full config, which ``--full`` also names, as
the reference's does):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_12b \\
      --batch 4 --prompt-len 2048 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_12b \\
      --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --federation \\
      --coordinator async --dim 2304 --classes 16 --port 8790 \\
      --ledger-dir /path/to/ledger
  PYTHONPATH=src python -m repro_torch.launch.serve --federation \\
      --coordinator sharded --shards 8 --tiled --dim 2304 --classes 16
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import steps as ST
from repro_torch.launch.inputs import sample_batch
from repro_torch.models import transformer as T


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0, *, device=None,
          params=None, on_step: Optional[Callable[[int, torch.Tensor], None]] = None):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens (drawn from
    ``seed``), then decode greedily to ``gen`` new tokens each.

    ``params`` defaults to ``T.init_params(cfg, seed)`` on ``device``; a
    caller may pass its own (e.g. the reference's, carried over by
    ``models.convert.params_from_jax``). ``on_step(i, logits)``, if given,
    sees the vocab logits (B, V) that chose new token ``i`` (0: the
    prefill's). Returns (tokens (B, prompt_len + gen) int numpy, prefill
    seconds, decode seconds), each timed to a synchronised end.
    """
    dev = resolve_device(device)
    max_seq = prompt_len + gen
    if params is None:
        params = T.init_params(cfg, seed=seed, device=dev)
    prefill = ST.make_prefill_step(cfg, max_seq)
    decode = ST.make_serve_step(cfg)
    b = sample_batch(cfg, batch, prompt_len, seed=seed, with_labels=False, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, b)
    _sync(dev)
    t1 = time.perf_counter()

    toks = [logits.argmax(-1).to(torch.int32)]
    if on_step is not None:
        on_step(0, logits)
    for i in range(gen - 1):
        logits, cache = decode(params, cache, toks[-1], prompt_len + i)
        toks.append(logits.argmax(-1).to(torch.int32))
        if on_step is not None:
            on_step(i + 1, logits)
    _sync(dev)
    t2 = time.perf_counter()

    out = np.concatenate([b["tokens"].cpu().numpy(), torch.stack(toks, 1).cpu().numpy()], 1)
    return out, t1 - t0, t2 - t1


def _make_endpoint(service, args):
    """Start the configured transport server: ``--mux`` → the multiplexed
    mux protocol, default → HTTP; either one TLS-wrapped when
    ``--tls-cert/--tls-key`` are given (plus required client certificates
    with ``--tls-client-ca``)."""
    from repro_torch.fl.service import serve_http

    ssl_ctx = None
    if args.tls_cert:
        from repro_torch.fl.mux import server_ssl_context

        if not args.tls_key:
            raise SystemExit("--tls-cert requires --tls-key")
        ssl_ctx = server_ssl_context(args.tls_cert, args.tls_key,
                                     client_ca=args.tls_client_ca)
    if args.mux:
        from repro_torch.fl.mux import serve_mux

        return serve_mux(service, args.host, args.port, ssl_context=ssl_ctx)
    return serve_http(service, args.host, args.port, ssl_context=ssl_ctx)


def serve_federation(args) -> None:
    """Host a FederationService over HTTP or mux until interrupted."""
    from repro_torch.fl import AFLServer, AsyncAFLServer, ShardedCoordinator
    from repro_torch.fl.service import FederationService

    # the shard mesh's devices come from --device (default: every card)
    shard_kw = dict(num_shards=args.shards, tiled_gram=args.tiled,
                    device=args.device)
    cls_kw = {
        "sync": (AFLServer, {}),
        "async": (AsyncAFLServer, {"max_pending": args.max_pending}),
        "sharded": (ShardedCoordinator, shard_kw),
    }[args.coordinator]
    kinds = {
        "sync": lambda: AFLServer(args.dim, args.classes, gamma=args.gamma),
        "async": lambda: AsyncAFLServer(args.dim, args.classes,
                                        gamma=args.gamma,
                                        max_pending=args.max_pending),
        "sharded": lambda: ShardedCoordinator(args.dim, args.classes,
                                              gamma=args.gamma, **shard_kw),
    }

    if args.standby_of or args.replica:
        serve_role(args, cls_kw)
        return

    if args.restore_from:
        import repro_torch.checkpoint as ckpt

        coordinator = ckpt.load_server(args.restore_from, cls_kw[0],
                                       **cls_kw[1])
        print(f"restored {args.coordinator} coordinator from "
              f"{args.restore_from} ({coordinator.num_clients} clients)")
    else:
        coordinator = kinds[args.coordinator]()
    service = FederationService(coordinator, max_pending=args.max_pending,
                                ledger_dir=args.ledger_dir,
                                auth_token=args.auth_token)
    with service, _make_endpoint(service, args) as srv:
        shards = getattr(coordinator, "num_shards", None)
        print(f"federation up: {srv.url}  "
              f"(coordinator={args.coordinator} d={args.dim} "
              f"C={args.classes} γ={args.gamma:g}"
              + (f" shards={shards} tiled={args.tiled}" if shards else "")
              + ")")
        if args.tls_cert:
            print(f"  TLS: {args.tls_cert}"
                  + (f" (client certs required: {args.tls_client_ca})"
                     if args.tls_client_ca else ""))
        if args.auth_token:
            print("  auth: bearer token required on every request")
        if args.ledger_dir:
            print(f"  ledger: {args.ledger_dir} "
                  "(every accepted submit, CRC-framed)")
        if args.mux:
            print(f"  point RemoteCoordinator at {srv.url} "
                  "(many clients per connection — interleaved streams)")
        else:
            print(f"  submit:  POST {srv.url}/v1/default/submit  "
                  "(ClientReport.to_bytes payload)")
            print(f"  weights: GET  {srv.url}/v1/default/weights")
        daemon = None
        if args.snapshot_dir:
            from repro_torch.checkpoint import SnapshotDaemon

            # in-proc pull (the service object, not the URL): no TLS /
            # token round-trips, and the live ledger object rides along so
            # successful ticks compact what each snapshot now covers
            daemon = SnapshotDaemon(
                service, directory=args.snapshot_dir,
                interval=args.snapshot_every, keep=args.snapshot_keep,
                ledger=service.ledger() if args.ledger_dir else None,
                auth_token=args.auth_token)
            daemon.start()
            print(f"  snapshots: {args.snapshot_dir} "
                  f"every {args.snapshot_every:g}s "
                  f"(keep {args.snapshot_keep}"
                  + (", ledger compacted per tick)" if args.ledger_dir
                     else ")"))
        print("ctrl-c to stop", flush=True)
        try:
            import threading

            threading.Event().wait()
        except KeyboardInterrupt:
            print("shutting down", flush=True)
        finally:
            if daemon is not None:
                daemon.stop()


def serve_role(args, cls_kw) -> None:
    """Host a warm standby (``--standby-of URL``) or a read-only weights
    replica (``--replica``), both following ``--ledger-dir``."""
    from repro_torch.fl import WarmStandby, WeightsReplica, watch_primary
    from repro_torch.fl.service import FederationService

    if not args.ledger_dir:
        raise SystemExit("--standby-of/--replica require --ledger-dir "
                         "(the primary's ledger, on shared storage)")
    cls, kw = cls_kw
    # Bootstrap kwargs: with no snapshot yet, the follower starts an EMPTY
    # coordinator of the configured shape and replays the whole ledger.
    boot_kw = dict(dim=args.dim, num_classes=args.classes,
                   gamma=args.gamma, **kw)
    if args.replica:
        replica = WeightsReplica(args.ledger_dir,
                                 snapshot_dir=args.snapshot_dir,
                                 cls=cls, ctor_kw=boot_kw, from_state_kw=kw)
        service = FederationService(replica, auth_token=args.auth_token)
        with service, _make_endpoint(service, args) as srv:
            print(f"weights replica up: {srv.url} "
                  f"(position={replica.position}, reads only — "
                  "writes get HTTP 403 read_only)")
            print("ctrl-c to stop", flush=True)
            try:
                import threading

                threading.Event().wait()
            except KeyboardInterrupt:
                print("shutting down", flush=True)
        return

    standby = WarmStandby(args.ledger_dir, snapshot_dir=args.snapshot_dir,
                          cls=cls, ctor_kw=boot_kw, from_state_kw=kw)
    service = FederationService()
    service.host_standby("default", standby, auth_token=args.auth_token)
    with service, _make_endpoint(service, args) as srv:
        print(f"warm standby up: {srv.url} "
              f"(tailing {args.ledger_dir}, watching {args.standby_of}; "
              "503 until promoted)", flush=True)

        def _alive() -> bool:
            from repro_torch.fl.mux import probe_alive

            return probe_alive(args.standby_of, cafile=args.watch_cafile,
                               auth_token=args.auth_token)

        watch_primary(standby, _alive, grace=args.grace,
                      interval=args.watch_every,
                      on_promote=lambda c: service.promote_federation())
        print(f"PROMOTED: primary missed {args.grace} liveness checks — "
              f"now serving writes at {srv.url} "
              f"({standby.coordinator.num_clients} clients, zero loss)",
              flush=True)
        try:
            import threading

            threading.Event().wait()
        except KeyboardInterrupt:
            print("shutting down", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None,
                    help="LLM serving arch (any family), e.g. gemma3_12b")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's smoke-test variant (default: full width)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the full config, the default (the reference's flag, "
                         "so that its command lines run unchanged)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions on the CPU); with --federation, where the "
                         "sharded coordinator's shards solve")
    fed = ap.add_argument_group("federation serving")
    fed.add_argument("--federation", action="store_true",
                     help="serve an AFL FederationService over HTTP (or "
                          "--mux) instead of LLM decode (no card, but for "
                          "the sharded coordinator's solves)")
    fed.add_argument("--dim", type=int, default=256)
    fed.add_argument("--classes", type=int, default=50)
    fed.add_argument("--gamma", type=float, default=1.0)
    fed.add_argument("--coordinator", default="sync",
                     choices=["sync", "async", "sharded"],
                     help="sync: AFLServer; async: AsyncAFLServer; sharded: "
                          "ShardedCoordinator over a shard mesh on --device")
    fed.add_argument("--host", default="127.0.0.1")
    fed.add_argument("--port", type=int, default=8790)
    fed.add_argument("--mux", action="store_true",
                     help="serve the multiplexed mux protocol instead of "
                          "HTTP (many interleaved streams per connection)")
    fed.add_argument("--tls-cert", default=None,
                     help="TLS server certificate PEM (enables TLS; see "
                          "repro_torch.fl.mux.generate_self_signed_cert)")
    fed.add_argument("--tls-key", default=None,
                     help="TLS server private key PEM (with --tls-cert)")
    fed.add_argument("--tls-client-ca", default=None,
                     help="require client certificates signed by this CA "
                          "PEM (mutual TLS)")
    fed.add_argument("--auth-token", default=None,
                     help="bearer token every request must carry "
                          "(typed 401 unauthorized otherwise)")
    fed.add_argument("--max-pending", type=int, default=None,
                     help="ingest high-watermark (HTTP 429 past it)")
    fed.add_argument("--shards", type=int, default=None,
                     help="sharded coordinator: shard count (default: one "
                          "a device)")
    fed.add_argument("--tiled", action="store_true",
                     help="sharded coordinator: row-tiled global Gram, "
                          "factored tile-parallel on the shards")
    fed.add_argument("--restore-from", default=None,
                     help="cold-start the coordinator from this checkpoint "
                          "directory (e.g. a snapshotd snap-*)")
    fed.add_argument("--snapshot-dir", default=None,
                     help="run an in-process snapshot daemon writing here")
    fed.add_argument("--snapshot-every", type=float, default=30.0,
                     help="snapshot interval seconds (with --snapshot-dir)")
    fed.add_argument("--snapshot-keep", type=int, default=5,
                     help="snapshots retained (with --snapshot-dir)")
    rep = ap.add_argument_group("replication (ledger / standby / replica)")
    rep.add_argument("--ledger-dir", default=None,
                     help="durable submit ledger directory: every accepted "
                          "submit is appended + fsynced before the ack")
    rep.add_argument("--standby-of", default=None, metavar="URL",
                     help="run as a warm standby of the primary at URL: "
                          "tail --ledger-dir, serve 503s, promote after "
                          "--grace failed liveness probes")
    rep.add_argument("--replica", action="store_true",
                     help="run as a read-only weights replica following "
                          "--ledger-dir (writes answer HTTP 403 read_only)")
    rep.add_argument("--grace", type=int, default=3,
                     help="standby: failed probes before promotion")
    rep.add_argument("--watch-every", type=float, default=1.0,
                     help="standby: seconds between liveness probes")
    rep.add_argument("--watch-cafile", default=None,
                     help="standby: CA PEM for probing a TLS primary "
                          "(muxs:// or https:// --standby-of URL)")
    args = ap.parse_args(argv)
    if args.federation:
        serve_federation(args)
        return
    if args.arch is None:
        ap.error("--arch is required for LLM serving (or pass --federation)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out, prefill_s, decode_s = serve(cfg, args.batch, args.prompt_len, args.gen, device=dev)
    n_new = args.batch * (args.gen - 1)
    print(f"arch={cfg.name} reduced={args.reduced} device={dev} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen}")
    print(f"prefill: {prefill_s * 1e3:.1f}ms   decode: {decode_s * 1e3:.1f}ms "
          f"({n_new / max(decode_s, 1e-9):.1f} tok/s over {args.gen - 1} steps)")
    if dev.type == "cuda":
        print(f"peak device memory: {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    print("first sequence tail:", out[0, -min(8, out.shape[1]):].tolist())


if __name__ == "__main__":
    main()
