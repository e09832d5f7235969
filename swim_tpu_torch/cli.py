"""swim-tpu-torch command-line interface (port of `swim_tpu/cli.py`).

Subcommands, with the reference's flags and JSON keys:
  info      derived protocol constants for a given cluster size
  demo      the stock demo: an N-node in-process cluster on
            deterministic virtual time, with optional kills and loss
  simulate  the tensor engines (dense, rumor, ring): N up to millions,
            faults as tensors, metrics as JSON
  study     the BASELINE studies (sim/experiments.py); `--mem-report`
            accounts the ring study's memory instead (obs/memwall.py)
  observe   analyze telemetry artifacts (flight-recorder dumps, span
            JSONL) or tail a live dump or a /metrics URL
  profile   phase-level step attribution (obs/prof.py)
  trend     per-tier bench trajectories with a --check regression gate
  bridge    serve a simulated cluster to an external core
  scenario  run, show, list or search the fault scenarios
  serve     the serving hub's load harness ('bench') and its tail
            attribution ('trace')
  audit     the contract audit (analysis/audit.py): build budget, wire
            payloads, tally completeness, working sets and hygiene,
            checked on what the port runs

The tensor commands run on the CUDA card unless `--device cpu` names
the CPU (swim_tpu_torch/device.py); with no card they exit 2 and say
so.  `--engine ringshard` runs the sharded ring engine
(parallel/ring_shard.py) and `--engine shard` the exchange-sharded
rumor engine (parallel/shard_engine.py): without `--device` over
`mesh.make_mesh()` (one shard per card, or 8 slots of one card), with
it on 8 slots of the named device.  Without `--device`, `simulate`
partitions dense, ring and rumor over `make_mesh()` where it holds two
or more distinct devices (parallel/partition.py), and reports their
count as `devices`.  `audit` writes no report unless
`--out` names a path (the reference's default path holds the
reference's own report).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ENGINES = ("auto", "dense", "rumor", "shard", "ring", "ringshard")


class _NoDevice(Exception):
    """The tensor device could not be resolved (no card)."""


def _device(args: argparse.Namespace):
    from swim_tpu_torch import device as devmod

    try:
        return devmod.resolve(args.device)
    except RuntimeError as e:
        raise _NoDevice(
            "error: no CUDA card: PyTorch sees none, and the tensor "
            "commands run on the card unless --device cpu names the CPU"
        ) from e


def _named_device(args: argparse.Namespace):
    """`--device` as given (None: the card, and for the sharded engines
    their default mesh), once `_device` has found it."""
    _device(args)
    return args.device


def _cmd_info(args: argparse.Namespace) -> int:
    import swim_tpu_torch

    cfg = swim_tpu_torch.SwimConfig(n_nodes=args.nodes)
    print(json.dumps({
        "version": swim_tpu_torch.__version__,
        "n_nodes": cfg.n_nodes,
        "k_indirect": cfg.k_indirect,
        "protocol_period_s": cfg.protocol_period,
        "suspicion_periods": cfg.suspicion_periods,
        "retransmit_limit": cfg.retransmit_limit,
        "max_piggyback": cfg.max_piggyback,
        "rumor_slots": cfg.rumor_slots,
    }, indent=2))
    return 0


def _cmd_demo(args: argparse.Namespace) -> int:
    from swim_tpu_torch import SwimConfig
    from swim_tpu_torch.core.cluster import SimCluster
    from swim_tpu_torch.types import Status

    cfg = SwimConfig(n_nodes=args.nodes, lifeguard=args.lifeguard)
    cluster = SimCluster(cfg, seed=args.seed, loss=args.loss)

    events = []
    for node in cluster.nodes:
        def listener(member, old, new, _id=node.id):
            if old is not None and old.status != new.status:
                events.append((cluster.clock.now(), _id, member,
                               new.status.name, new.incarnation))
        node.members.listeners.append(listener)

    cluster.start()
    cluster.run(args.settle)
    print(f"# {args.nodes}-node in-process cluster converged "
          f"(k={cfg.k_indirect}, period={cfg.protocol_period}s, "
          f"seed={args.seed}, loss={args.loss})")

    for victim in args.kill:
        print(f"# t={cluster.clock.now():.1f}s: killing node {victim}")
        cluster.kill(victim)
    cluster.run(args.duration)

    if not args.quiet:
        for t, observer, member, status, inc in events[-args.tail:]:
            print(f"t={t:7.2f}s  node{observer:<4d} sees node{member:<4d} "
                  f"{status}@{inc}")
    live = [i for i in range(args.nodes) if i not in set(args.kill)]
    summary = {
        "sim_seconds": round(cluster.clock.now(), 2),
        "messages_sent": cluster.network.sent,
        "messages_delivered": cluster.network.delivered,
        "status_transitions": len(events),
        "killed": args.kill,
        "all_kills_detected_everywhere": all(
            cluster.all_consider(v, Status.DEAD, among=live)
            for v in args.kill),
        "false_deaths": sum(
            1 for m in live for i in live
            if cluster.nodes[i].members.opinion(m).status == Status.DEAD),
        "refutations": sum(n.stats["refutations"] for n in cluster.nodes),
    }
    print(json.dumps(summary))
    return 0 if (summary["all_kills_detected_everywhere"] or not args.kill) \
        else 1


def _reject_sel_scope(resolved_engine: str, sel_scope: str) -> bool:
    """True (after printing the error) iff a non-wave --sel-scope was
    passed for an engine that would silently ignore it."""
    if sel_scope != "wave" and not resolved_engine.startswith("ring"):
        print(f"error: --sel-scope {sel_scope} has no effect on the "
              f"'{resolved_engine}' engine; pass --engine ring or "
              "ringshard", file=sys.stderr)
        return True
    return False


def _cmd_simulate(args: argparse.Namespace) -> int:
    import contextlib
    import time

    from swim_tpu_torch import SwimConfig
    from swim_tpu_torch.models import dense, ring, rumor
    from swim_tpu_torch.ops import lattice
    from swim_tpu_torch.sim import experiments, faults
    from swim_tpu_torch.utils import profiling, threefry

    engine = experiments.pick_engine(args.nodes, args.engine)
    if _reject_sel_scope(engine, args.sel_scope):
        return 2
    dev = _device(args)
    cfg = SwimConfig(n_nodes=args.nodes, suspicion_mult=args.suspicion_mult,
                     lifeguard=args.lifeguard,
                     ring_sel_scope=args.sel_scope)
    plan = faults.none(args.nodes, dev)
    if args.loss:
        plan = faults.with_loss(plan, args.loss)
    if args.crash_fraction:
        plan = faults.with_random_crashes(
            plan, threefry.key(args.seed + 1), args.crash_fraction,
            0, max(1, args.periods // 2))
    from swim_tpu_torch.parallel import mesh as pmesh
    from swim_tpu_torch.parallel import partition

    mesh = None
    if args.device is None and engine in experiments.PARTITIONED:
        # partitioned over every device where there are two or more, as
        # the reference's GSPMD partitions the step
        mesh = pmesh.make_mesh()
        mesh = mesh if partition.partitions(mesh) else None
    if mesh is not None:
        mesh, state, placed_plan, _ = partition.start(cfg, engine, plan, mesh)
        run_fn = partition.build_run(cfg, mesh, engine, args.periods)
    elif engine in ("shard", "ringshard"):
        if engine == "shard":
            from swim_tpu_torch.parallel import shard_engine as par_mod
        else:
            from swim_tpu_torch.parallel import ring_shard as par_mod
        mesh, state, placed_plan, _ = par_mod.start(cfg, plan, args.device)
        run_fn = par_mod.build_run(cfg, mesh, args.periods)
    if mesh is not None:
        devices = len(mesh.distinct)

        def do_run(st):
            return pmesh.assemble(run_fn(st, placed_plan,
                                         threefry.key(args.seed)))
    else:
        mod = {"dense": dense, "ring": ring, "rumor": rumor}[engine]
        state = mod.init_state(cfg, dev)
        devices = 1

        def do_run(st):
            return mod.run(cfg, st, plan, args.seed, args.periods)

    prof = (profiling.trace(args.profile) if args.profile
            else contextlib.nullcontext())
    t0 = time.perf_counter()
    with prof:
        state = do_run(state)
        profiling.block_until_ready(state)
    dt = time.perf_counter() - t0

    crashed = plan.crash_step.cpu().numpy() <= args.periods
    live = ~crashed
    if engine == "dense":
        dead_views = lattice.is_dead(state.key).cpu().numpy()
    elif engine in ("ring", "ringshard"):
        dead_views = None          # summarized via the dissemination floor
    else:
        dead_views = (lattice.is_dead(rumor.view_matrix(cfg, state))
                      .cpu().numpy() if args.nodes <= 8192 else None)
    out = {
        "nodes": args.nodes,
        "engine": engine,
        "periods": args.periods,
        "seconds": round(dt, 3),
        "periods_per_sec": round(args.periods / dt, 2),
        "crashed": int(crashed.sum()),
        "devices": devices,
        # a period-scope (deviation R5) run must never be quotable as an
        # exact wave-scope one
        **({"ring_sel_scope": cfg.ring_sel_scope}
           if engine in ("ring", "ringshard") else {}),
    }
    if dead_views is not None:
        import numpy as np

        detected = (dead_views[np.ix_(live, crashed)].all(axis=0).sum()
                    if crashed.any() else 0)
        out["crashed_detected_by_all_live"] = int(detected)
        out["false_deaths"] = int(dead_views[np.ix_(live, live)].sum())
    else:
        gone = lattice.is_dead(state.gone_key).cpu().numpy()
        out["tombstoned"] = int(gone.sum())
        out["tombstoned_crashed"] = int((gone & crashed).sum())
        out["overflow"] = int(state.overflow)
    print(json.dumps(out))
    return 0


def _cmd_study(args: argparse.Namespace) -> int:
    from swim_tpu_torch.sim import experiments

    if args.mem_report:
        if args.study != "detection":
            print("error: --mem-report is a detection-study option",
                  file=sys.stderr)
            return 2
        resolved = experiments.pick_engine(args.nodes, args.engine)
        if args.engine != "auto" and not resolved.startswith("ring"):
            print("error: --mem-report accounts the ring study "
                  "pipeline; pass --engine ring or ringshard",
                  file=sys.stderr)
            return 2
        from swim_tpu_torch.obs import memwall

        cfg_kw = {}
        if args.sel_scope != "wave":
            cfg_kw["ring_sel_scope"] = args.sel_scope
        try:
            report = memwall.study_memory_analysis(
                args.nodes, periods=args.periods,
                crash_fraction=args.crash_fraction,
                variant="stacked" if args.stream == "off" else "stream",
                engine=("ringshard" if resolved == "ringshard"
                        else "ring"), device=_named_device(args),
                probe=args.probe or "pull", **cfg_kw)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(json.dumps(report))
        return 0
    kw = dict(n=args.nodes, periods=args.periods, seed=args.seed,
              engine=args.engine)
    if args.sel_scope != "wave":
        resolved = experiments.pick_engine(args.nodes, args.engine)
        if _reject_sel_scope(resolved, args.sel_scope):
            return 2
        kw["ring_sel_scope"] = args.sel_scope   # flows into SwimConfig
    if args.probe:
        resolved = experiments.pick_engine(args.nodes, args.engine)
        if not resolved.startswith("ring"):
            print(f"error: --probe {args.probe} has no effect on the "
                  f"'{resolved}' engine; pass --engine ring or "
                  "ringshard", file=sys.stderr)
            return 2
        kw["ring_probe"] = args.probe   # flows into SwimConfig
    if args.telemetry:
        kw["telemetry"] = True          # flows into SwimConfig
    if args.flight_record:
        if args.study != "detection":
            print("error: --flight-record is a detection-study option",
                  file=sys.stderr)
            return 2
        kw["telemetry"] = True
        kw["flight_record"] = args.flight_record
    if args.study != "detection" and (args.stream != "auto"
                                      or args.checkpoint_dir):
        print("error: --stream/--checkpoint-dir are detection-study "
              "options", file=sys.stderr)
        return 2
    if args.study == "detection":
        kw["crash_fraction"] = args.crash_fraction
        if args.stream != "auto":
            kw["stream"] = args.stream == "on"
        if args.checkpoint_dir:
            kw["checkpoint_dir"] = args.checkpoint_dir
            kw["checkpoint_every"] = args.checkpoint_every
    elif args.study == "fp_sweep":
        if args.losses:
            kw["losses"] = tuple(args.losses)
        kw["partition"] = not args.no_partition
    elif args.study == "suspicion_sweep":
        kw["mults"] = tuple(args.mults)
        kw["crash_fraction"] = args.crash_fraction
        kw["loss"] = args.loss
        if args.losses:
            kw["losses"] = tuple(args.losses)
    elif args.study == "lifeguard":
        kw["crash_fraction"] = args.crash_fraction
        kw["loss"] = args.loss
        kw["budget_arms"] = args.budget_arms
    out = experiments.STUDIES[args.study](**kw, device=_named_device(args))
    if kw.get("ring_sel_scope"):
        # a period-scope (deviation R5) study must never be quotable as
        # an exact wave-scope one
        out = {**out, "ring_sel_scope": kw["ring_sel_scope"]}
    print(json.dumps(out))
    return 0


def _scrape_metrics(url: str) -> dict:
    """One GET of a Prometheus /metrics endpoint, reduced to the
    swim_health_* gauge set and counter totals (summed across node
    labels): the live-view payload of `observe --follow URL`."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        text = resp.read().decode()
    health: dict[str, float] = {}
    counters: dict[str, float] = {}
    build = ""
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name_labels, _, val = line.rpartition(" ")
        name = name_labels.split("{", 1)[0]
        try:
            v = float(val)
        except ValueError:
            continue
        if name.startswith("swim_health_"):
            health[name[len("swim_health_"):]] = max(
                v, health.get(name[len("swim_health_"):], 0.0))
        elif name.endswith("_total"):
            counters[name] = counters.get(name, 0.0) + v
        elif name == "swim_build_info":
            build = name_labels[len(name):]
    report: dict = {"kind": "metrics_scrape", "url": url,
                    "health": health, "counters": counters}
    if build:
        report["build_info"] = build
    return report


def _render_scrape(report: dict) -> str:
    status = int(report["health"].get("status", 0))
    lines = [f"metrics scrape · {report['url']}",
             f"health: {('ok', 'warn', 'ERROR')[min(status, 2)]}"]
    firing = [r for r, v in report["health"].items()
              if r != "status" and v > 0]
    for rule in firing:
        lines.append(f"  firing: {rule}")
    for name, v in sorted(report["counters"].items()):
        lines.append(f"  {name} {int(v)}")
    if report.get("build_info"):
        lines.append(f"  build {report['build_info']}")
    return "\n".join(lines)


def _cmd_observe(args: argparse.Namespace) -> int:
    import time

    from swim_tpu_torch.obs import analyze

    is_url = (len(args.paths) == 1
              and args.paths[0].startswith(("http://", "https://")))
    if is_url and not args.follow and not args.json:
        args.follow = True      # a bare URL is a live view by definition

    def once() -> tuple[str, dict | None]:
        if is_url:
            report = _scrape_metrics(args.paths[0])
            return ((json.dumps(report, indent=2) if args.json
                     else _render_scrape(report)), report)
        report = analyze.analyze_paths(args.paths, window=args.window)
        return ((json.dumps(report, indent=2) if args.json
                 else analyze.render_report(report)), report)

    if not args.follow:
        try:
            text, report = once()
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(text)
        if args.check and report is not None \
                and not is_url and analyze.error_findings(report):
            return 1
        return 0

    i = 0
    while True:
        try:
            text, _ = once()
        except (OSError, ValueError) as e:
            text = f"(waiting: {e})"
        # redraw in place: clear the screen and home, like watch(1)
        sys.stdout.write("\x1b[2J\x1b[H" + text + "\n")
        sys.stdout.flush()
        i += 1
        if args.iterations and i >= args.iterations:
            return 0
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


def _cmd_profile(args: argparse.Namespace) -> int:
    from swim_tpu_torch import SwimConfig
    from swim_tpu_torch.obs import prof as prof_mod

    # the defaults are the reference's 65k lean anchor
    cfg = SwimConfig(
        n_nodes=args.nodes, ring_probe=args.probe,
        ring_sel_scope=args.sel_scope,
        suspicion_mult=args.suspicion_mult,
        retransmit_mult=args.retransmit_mult,
        k_indirect=args.k_indirect,
        ring_window_periods=args.window_periods,
        ring_view_c=args.view_c)
    report = prof_mod.profile_ring(
        cfg, settle=args.settle, reps=args.reps, seed=args.seed,
        crash_fraction=args.crash_fraction,
        trace_dir=args.trace or None, top_k=args.top,
        device=_device(args))
    if args.out:
        path = prof_mod.save_artifact(
            report, None if args.out == "auto" else args.out)
        print(f"# wrote {path}", file=sys.stderr)
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        print(prof_mod.render_report(report))
    if args.check and report["coverage_pct"] < report.get(
            "contract_coverage_pct", 95.0):
        return 1
    return 0


def _cmd_trend(args: argparse.Namespace) -> int:
    from swim_tpu_torch.obs import trend

    argv = []
    if args.repo:
        argv += ["--repo", args.repo]
    argv += ["--threshold", str(args.threshold)]
    if args.json:
        argv.append("--json")
    if args.check:
        argv.append("--check")
    return trend.main(argv)


def _cmd_bridge(args: argparse.Namespace) -> int:
    from swim_tpu_torch import SwimConfig
    from swim_tpu_torch.bridge import BridgeServer

    cfg = SwimConfig(n_nodes=max(args.internal + 1, 2),
                     lifeguard=args.lifeguard)
    server = BridgeServer(cfg, n_internal=args.internal, seed=args.seed,
                          loss=args.loss, host=args.host, port=args.port,
                          metrics_port=args.metrics_port)
    server.start()
    out = {"listening": list(server.address),
           "internal_nodes": args.internal}
    if server.metrics_address is not None:
        out["metrics"] = list(server.metrics_address)
    print(json.dumps(out), flush=True)
    server.join(timeout=args.timeout)
    server.close()
    return 0


def _cmd_scenario(args: argparse.Namespace) -> int:
    from swim_tpu_torch.sim import scenario

    if args.action == "list":
        rows = []
        for name in sorted(scenario.LIBRARY):
            sc = scenario.LIBRARY[name]
            mode = sc.study or sc.engine
            rows.append((name, mode, sc.n,
                         sc.description.split(".  ")[0].rstrip(".")))
        if args.json:
            print(json.dumps([{"name": n, "mode": m, "n": nn, "about": d}
                              for n, m, nn, d in rows], indent=1))
        else:
            w = max(len(r[0]) for r in rows)
            for n, m, nn, d in rows:
                print(f"{n:<{w}}  {m:<9} n={nn:<7} {d}")
        return 0
    if args.action == "search":
        from swim_tpu_torch.sim import search as scenario_search

        out = os.path.join(args.out_dir, "scenario_search_boundary.json")
        os.makedirs(args.out_dir, exist_ok=True)
        report = scenario_search.search(
            generations=args.generations, pop=args.pop, seed=args.seed,
            out=out, device=_device(args))
        if args.json:
            print(json.dumps(report, indent=1, sort_keys=True,
                             default=str))
        else:
            b = report["boundary"]
            viols = report["explore"]["violations"]
            print(f"search: evaluated "
                  f"{report['explore']['evaluated']} candidates, "
                  f"{len(report['explore']['archive'])} behavior cells, "
                  f"{len(viols)} violation hits -> {out}")
            if b.get("found"):
                print(f"  flap false-dead boundary: clean at level "
                      f"{b['clean_level']}, violating at "
                      f"{b['violation_level']} (width {b['width']})")
        if args.check and not report["boundary"].get("found"):
            return 1
        return 0
    if args.name is None:
        print("scenario show/run need a scenario name "
              f"(one of {sorted(scenario.LIBRARY)})", file=sys.stderr)
        return 2
    sc = scenario.get(args.name)
    if args.action == "show":
        scenario.validate(sc)
        print(json.dumps(sc.spec_dict(), indent=1, sort_keys=True))
        return 0
    verdict, path = scenario.run(sc, out_dir=args.out_dir,
                                 batch=args.batch, device=_device(args))
    if args.json:
        print(json.dumps(verdict, indent=1, sort_keys=True,
                         default=str))
    else:
        print(f"{sc.name}: {verdict['verdict']}  -> {path}")
        for c in verdict["checks"]:
            mark = "ok " if c["ok"] else "FAIL"
            detail = {k: v for k, v in c.items()
                      if k not in ("check", "ok", "fired")}
            print(f"  [{mark}] {c['check']} {json.dumps(detail, default=str)}")
    if args.check and verdict["verdict"] != "pass":
        return 1
    return 0


def _cmd_audit(args: argparse.Namespace) -> int:
    import time

    from swim_tpu_torch.analysis import audit

    dev = _device(args)
    t0 = time.perf_counter()
    report = audit.run_audit(wire_n=args.wire_n, retrace_n=args.retrace_n,
                             device=dev)
    # the wall time goes to stderr: the report holds none (byte-stable)
    print(f"# audit: {time.perf_counter() - t0:.2f} s on {dev}",
          file=sys.stderr)
    if args.out:
        audit.write_report(report, args.out)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        for contract in sorted(report["contracts"]):
            blob = report["contracts"][contract]
            print(f"[{blob['status']:>6}] {contract}")
            for row in blob["checks"]:
                mark = {"pass": ".", "waived": "w",
                        "not_applicable": "-"}.get(row["status"], "F")
                print(f"   {mark} {row['arm']}: {row['detail']}")
        totals = report["totals"]
        print(f"{totals['checks_total']} checks, "
              f"{totals['failures']} failed, {totals['waived']} waived, "
              f"{totals['not_applicable']} not applicable")
    ok, failures = audit.check_report(report)
    if args.check and not ok:
        for line in failures:
            print(f"AUDIT FAIL {line}", file=sys.stderr)
        return 1
    return 0


def _cmd_serve(args: argparse.Namespace) -> int:
    from swim_tpu_torch.serve import load as serve_load

    dev = _device(args)
    if args.action == "trace":
        from swim_tpu_torch.obs import analyze

        res = serve_load.run_trace(
            n_nodes=args.nodes, sessions=args.sessions,
            periods=args.periods, seed=args.seed,
            n_sockets=args.sockets, echo_samples=args.echo_samples,
            frontend=args.frontend, device=dev)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            # byte-stable on re-read: sorted keys, no timestamps
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1, sort_keys=True)
                f.write("\n")
        if args.json:
            print(json.dumps(res, indent=2, sort_keys=True))
        else:
            print(analyze.render_report(res, title="serve trace"))
            print(f"digests_match: {res['digests_match']}")
        return 0 if res.get("ok_parity") else 1

    res = serve_load.run_load(
        n_nodes=args.nodes, sessions=args.sessions,
        periods=args.periods, seed=args.seed,
        n_sockets=args.sockets, echo_samples=args.echo_samples,
        frontend=args.frontend, device=dev)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("clean", "storm")}
                     if not args.json else res, indent=2))
    return 0 if res.get("ok_parity") else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="swim-tpu-torch",
        description="SWIM failure-detection framework & simulator "
                    "(PyTorch, one CUDA card)",
    )
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="tensor device (default: the CUDA card; the "
                        "commands exit 2 when there is none). 'cpu' "
                        "runs the plain versions of the kernels on the "
                        "host")
    sub = p.add_subparsers(dest="command", required=True)

    info = sub.add_parser("info", help="show derived protocol constants")
    info.add_argument("--nodes", type=int, default=32)
    info.set_defaults(fn=_cmd_info)

    demo = sub.add_parser(
        "demo", help="N-node in-process cluster (the stock demo)")
    demo.add_argument("--nodes", type=int, default=32)
    demo.add_argument("--seed", type=int, default=0)
    demo.add_argument("--loss", type=float, default=0.0)
    demo.add_argument("--kill", type=int, nargs="*", default=[],
                      help="node ids to crash after settling")
    demo.add_argument("--settle", type=float, default=10.0,
                      help="seconds of sim time before injecting kills")
    demo.add_argument("--duration", type=float, default=30.0,
                      help="seconds of sim time after kills")
    demo.add_argument("--lifeguard", action="store_true")
    demo.add_argument("--tail", type=int, default=20,
                      help="show the last K status transitions")
    demo.add_argument("--quiet", action="store_true")
    demo.set_defaults(fn=_cmd_demo)

    sim = sub.add_parser("simulate", help="tensor-engine simulation")
    sim.add_argument("--nodes", type=int, default=1024)
    sim.add_argument("--periods", type=int, default=100)
    sim.add_argument("--seed", type=int, default=0)
    sim.add_argument("--loss", type=float, default=0.0)
    sim.add_argument("--crash-fraction", type=float, default=0.01)
    sim.add_argument("--suspicion-mult", type=float, default=5.0)
    sim.add_argument("--lifeguard", action="store_true")
    sim.add_argument("--engine", choices=ENGINES, default="auto")
    sim.add_argument("--sel-scope", choices=("wave", "period"),
                     default="wave",
                     help="ring piggyback-selection freshness (deviation "
                          "R5: 'period' selects once per period from "
                          "start-of-period state, the throughput mode)")
    sim.add_argument("--profile", default="",
                     help="write a torch.profiler Chrome trace to this "
                          "dir")
    sim.set_defaults(fn=_cmd_simulate)

    st = sub.add_parser(
        "study", help="BASELINE.md studies (configs 2-5) → JSON")
    st.add_argument("study", choices=("detection", "fp_sweep",
                                      "suspicion_sweep", "lifeguard"))
    st.add_argument("--nodes", type=int, default=1000)
    st.add_argument("--periods", type=int, default=100)
    st.add_argument("--seed", type=int, default=0)
    st.add_argument("--engine", choices=ENGINES, default="auto")
    st.add_argument("--crash-fraction", type=float, default=0.01)
    st.add_argument("--loss", type=float, default=0.05)
    st.add_argument("--losses", type=float, nargs="*", default=None,
                    help="loss-rate grid (fp_sweep; also turns "
                         "suspicion_sweep into a mults x losses grid)")
    st.add_argument("--mults", type=float, nargs="*",
                    default=[2.0, 3.0, 5.0, 8.0])
    st.add_argument("--no-partition", action="store_true")
    st.add_argument("--sel-scope", choices=("wave", "period"),
                    default="wave",
                    help="ring piggyback-selection freshness (deviation "
                         "R5; 'period' = the throughput mode)")
    st.add_argument("--budget-arms", action="store_true",
                    help="lifeguard study: add ring_orig_words=8 twin "
                         "arms (budget-vs-LHA attribution)")
    st.add_argument("--telemetry", action="store_true",
                    help="collect per-period engine telemetry "
                         "(EngineFrame) inside the study; adds a "
                         "'telemetry' digest to the JSON. Protocol state "
                         "is bitwise identical either way")
    st.add_argument("--flight-record", default=None, metavar="PATH",
                    help="detection study: always dump the flight "
                         "recorder's JSONL to PATH (implies --telemetry; "
                         "without this, a dump still fires on anomaly)")
    st.add_argument("--probe", choices=("rotor", "pull"), default=None,
                    help="ring probe pattern override. The detection "
                         "study defaults the ring engine to 'pull' "
                         "(uniform probing: the paper's e/(e-1) law); "
                         "'rotor' opts into the bounded-detection "
                         "throughput mode (deviation R1). Other studies "
                         "default to rotor.")
    st.add_argument("--stream", choices=("auto", "on", "off"),
                    default="auto",
                    help="detection study: drive the ring engine through "
                         "the streaming O(crashes) runner instead of the "
                         "stacked [periods, N] track. 'auto' streams at "
                         ">= 2M nodes (or whenever checkpointing is on); "
                         "milestones and series are bitwise identical "
                         "either way")
    st.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="detection study: mid-study checkpoints in DIR; "
                         "when DIR already holds a snapshot the study "
                         "resumes from it, bitwise identical to an "
                         "uninterrupted run")
    st.add_argument("--checkpoint-every", type=int, default=0,
                    metavar="PERIODS",
                    help="checkpoint cadence in periods (default: one "
                         "snapshot per streaming chunk boundary)")
    st.add_argument("--mem-report", action="store_true",
                    help="don't report the study: account its memory at "
                         "this shape as JSON (obs/memwall.py). On the "
                         "card it runs the study program once and reads "
                         "its peak allocation against the card's memory; "
                         "with --device cpu it gives the trees' bytes "
                         "only")
    st.set_defaults(fn=_cmd_study)

    ob = sub.add_parser(
        "observe", help="analyze telemetry artifacts (flight-recorder "
                        "dump / trace-span JSONL) or tail a live dump "
                        "or /metrics URL")
    ob.add_argument("paths", nargs="+",
                    help="recorder dump and/or span JSONL paths, or ONE "
                         "http(s)://host:port/metrics URL")
    ob.add_argument("--json", action="store_true",
                    help="emit the raw analyzer report as JSON")
    ob.add_argument("--follow", action="store_true",
                    help="refreshing terminal view: re-analyze the "
                         "file(s) or re-scrape the URL every --interval")
    ob.add_argument("--interval", type=float, default=2.0)
    ob.add_argument("--iterations", type=int, default=0,
                    help="stop --follow after K refreshes (0 = until ^C)")
    ob.add_argument("--window", type=int, default=16,
                    help="health-rule sliding window, in periods")
    ob.add_argument("--check", action="store_true",
                    help="exit 1 if any error-severity health finding "
                         "(CI gate)")
    ob.set_defaults(fn=_cmd_observe)

    sc = sub.add_parser(
        "scenario", help="compile & run adversarial fault scenarios "
                         "(sim/scenario.py library) gated by the "
                         "observatory")
    sc.add_argument("action", choices=("list", "show", "run", "search"))
    sc.add_argument("name", nargs="?", default=None,
                    help="library scenario name (hyphens ok: "
                         "rack-outage, flap, flap-boundary, gray-10pct, "
                         "replay-storm, baseline-config3, lean-fidelity)")
    sc.add_argument("--out-dir", default="scenario_out",
                    help="where verdict artifacts + telemetry dumps go")
    sc.add_argument("--json", action="store_true",
                    help="emit the full verdict JSON")
    sc.add_argument("--check", action="store_true",
                    help="exit 1 unless every scenario check passes "
                         "(CI gate)")
    sc.add_argument("--batch", action="store_true",
                    help="run the engine arms as batches per shared "
                         "config (sim/faults.py ProgramBatch); the "
                         "verdict is bitwise identical to serial")
    sc.add_argument("--generations", type=int, default=4,
                    help="[search] mutation generations")
    sc.add_argument("--pop", type=int, default=16,
                    help="[search] candidates per generation")
    sc.add_argument("--seed", type=int, default=0,
                    help="[search] deterministic search seed")
    sc.set_defaults(fn=_cmd_scenario)

    pr = sub.add_parser(
        "profile", help="phase-level step attribution with roofline "
                        "byte accounting (obs/prof.py)")
    pr.add_argument("--nodes", type=int, default=65536)
    pr.add_argument("--settle", type=int, default=2,
                    help="periods to run before timing (steady state)")
    pr.add_argument("--reps", type=int, default=5,
                    help="timed dispatches per program (best-of)")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--crash-fraction", type=float, default=0.001)
    pr.add_argument("--probe", choices=("rotor", "pull"), default="rotor")
    pr.add_argument("--sel-scope", choices=("wave", "period"),
                    default="period",
                    help="default 'period': the throughput mode, whose "
                         "fused path exposes all six phases")
    pr.add_argument("--suspicion-mult", type=float, default=2.0)
    pr.add_argument("--retransmit-mult", type=float, default=2.0)
    pr.add_argument("--k-indirect", type=int, default=1)
    pr.add_argument("--window-periods", type=int, default=3)
    pr.add_argument("--view-c", type=int, default=2)
    pr.add_argument("--trace", default="",
                    help="also capture a torch.profiler trace to this "
                         "dir and attach the top-op table")
    pr.add_argument("--top", type=int, default=5,
                    help="top-K kernels from the device trace")
    pr.add_argument("--json", action="store_true",
                    help="emit the raw report as JSON")
    pr.add_argument("--out", default="",
                    help="write the report artifact ('auto' = "
                         "prof_out/profile_phases.json, the file the "
                         "bridge's swim_prof_* gauges serve)")
    pr.add_argument("--check", action="store_true",
                    help="exit 1 if attribution coverage misses the "
                         "≥95%% contract")
    pr.set_defaults(fn=_cmd_profile)

    tr = sub.add_parser(
        "trend", help="per-tier bench p/s trajectories + regression "
                      "gate (obs/trend.py)")
    tr.add_argument("--repo", default=None,
                    help="repo root holding BENCH_r*.json + "
                         "bench_results/ (default: auto-detect)")
    tr.add_argument("--threshold", type=float, default=0.10)
    tr.add_argument("--json", action="store_true")
    tr.add_argument("--check", action="store_true",
                    help="exit 1 when any tier regresses >threshold "
                         "vs its last-good round")
    tr.set_defaults(fn=_cmd_trend)

    br = sub.add_parser(
        "bridge", help="serve a simulated cluster for an external core "
                       "(bridge/protocol.py)")
    br.add_argument("--internal", type=int, default=8,
                    help="in-process nodes to pre-populate")
    br.add_argument("--host", default="127.0.0.1")
    br.add_argument("--port", type=int, default=0)
    br.add_argument("--seed", type=int, default=0)
    br.add_argument("--loss", type=float, default=0.0)
    br.add_argument("--lifeguard", action="store_true")
    br.add_argument("--timeout", type=float, default=3600.0)
    br.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text exposition on GET "
                         "/metrics at this port (0 = ephemeral)")
    br.set_defaults(fn=_cmd_bridge)

    au = sub.add_parser(
        "audit", help="contract audit: build budget, wire payloads, tally "
                      "completeness, working sets and hygiene, checked on "
                      "the port's eager programs (analysis/audit.py)")
    au.add_argument("--out", default="",
                    help="report path (default '': write nothing)")
    au.add_argument("--wire-n", type=int, default=512,
                    help="node count for the 2x2 sharded wire arms")
    au.add_argument("--retrace-n", type=int, default=256,
                    help="node count for the build, hygiene and working-set "
                         "arms")
    au.add_argument("--json", action="store_true",
                    help="print the full report JSON")
    au.add_argument("--check", action="store_true",
                    help="exit 1 on any unwaived contract failure")
    au.set_defaults(fn=_cmd_audit)

    sv = sub.add_parser(
        "serve", help="serving hub: async session admission over a "
                      "free-running ring engine (serve/)")
    sv.add_argument("action", choices=("bench", "trace"),
                    help="'bench': the 10^3-client load harness "
                         "(clean arm vs replay/duplication storm; "
                         "exit 1 unless the arms stay bitwise-parity); "
                         "'trace': tail-latency attribution, an "
                         "untraced parity arm then a traced arm whose "
                         "phase timeline decomposes the echo-RTT p99 "
                         "(exit 1 unless bitwise parity and >=90% of "
                         "the tail is attributed)")
    sv.add_argument("--nodes", type=int, default=1_000_000)
    sv.add_argument("--sessions", type=int, default=1000)
    sv.add_argument("--periods", type=int, default=3)
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--sockets", type=int, default=16,
                    help="client UDP sockets the sessions multiplex "
                         "over (sessions never cost fds)")
    sv.add_argument("--echo-samples", type=int, default=2000,
                    help="OP_ECHO RTT probes behind the p50/p99")
    sv.add_argument("--frontend", choices=("auto", "udppump", "socket"),
                    default="auto",
                    help="hub datapath: the udppump epoll frontend "
                         "when the native toolchain is present")
    sv.add_argument("--out", default="",
                    help="write the full result JSON here ('serve "
                         "trace' writes it byte-stable: sorted keys, no "
                         "timestamps)")
    sv.add_argument("--json", action="store_true",
                    help="print the full result (arms included)")
    sv.set_defaults(fn=_cmd_serve)
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except _NoDevice as e:
        print(str(e), file=sys.stderr)
        return 2
    except BrokenPipeError:
        # `swim-tpu-torch observe ... | head` closing the pipe is not an
        # error
        sys.stderr.close()
        return 0


if __name__ == "__main__":
    sys.exit(main())
