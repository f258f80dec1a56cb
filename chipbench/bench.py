"""One run of one cell: set-up, the measured window, the traced slice,
and the check of what the window served.

The traffic is a closed loop in rounds: a round submits one request for
every image of the pool, in an order drawn from the seed, to
``ServeEngine`` and drains it; the next round starts when the last answer
is back.  Every round is the same work, so every seed measures the same
amount of it.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import time

import numpy as np
import torch

from chipbench import check, devtrace, energy, inputs, yardstick

WARM_ROUNDS = 2
# rounds of the traced slice after the window
PROFILE_ROUNDS = 3


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    metrics: list      # (name, unit, reader) of its per-layer metrics
    # what the check keeps and the trace sees: the same for every cell
    # (smaller only in the tests)
    check_forwards: int = check.FORWARDS
    check_rows: int = check.ROWS
    profile_rounds: int = PROFILE_ROUNDS


class HarnessRunner:
    """The program's runner, with the benchmark's spans around each call
    into it and the layer capture around each forward."""

    def __init__(self, runner, spans: devtrace.Spans, capture: check.Capture):
        self.runner, self.spans, self.capture = runner, spans, capture
        self.device = runner.device

    def shape_key(self, payload):
        return self.runner.shape_key(payload)

    def collate(self, payloads, pad_to: int):
        if not self.spans.on:
            return self.runner.collate(payloads, pad_to)
        with self.spans.span("engine.collate"):
            return self.runner.collate(payloads, pad_to)

    def replica(self, device) -> "HarnessRunner":
        return HarnessRunner(self.runner.replica(device), self.spans,
                             self.capture)

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        self.capture.begin(x)
        try:
            if not self.spans.on:
                return self.runner.forward(x, key)
            with self.spans.span("executor.forward"):
                return self.runner.forward(x, key)
        finally:
            self.capture.end()


def reference_module(cfg: dict):
    return importlib.import_module(f"chipbench.reference.{cfg['reference']}")


def quant_config(cfg: dict):
    from repro_torch.core.quant import QuantConfig

    return QuantConfig(w_bits=cfg["w_bits"], a_bits=cfg["a_bits"],
                       g_bits=cfg["g_bits"],
                       first_last_fp=cfg["first_last_fp"],
                       engine=cfg["engine"])


def program_spec(cfg: dict, layers) -> list:
    """The program's spec of the network (``cfg["program_spec"]`` of
    ``repro_torch.models.cnn``, called with the configuration's values of
    the keys ``cfg["program_spec_args"]`` names), held to the reference's
    shapes."""
    import repro_torch.models.cnn as cnn

    spec = getattr(cnn, cfg["program_spec"])(
        **{k: cfg[k] for k in cfg["program_spec_args"]})
    fields = ("cin", "cout", "k", "stride", "pool", "fc", "role")
    got = [tuple(getattr(s, f) for f in fields) for s in spec]
    want = [tuple(getattr(l, f) for f in fields) for l in layers]
    if got != want:
        raise ValueError(f"{cfg['program_spec']} gives {got}; the reference "
                         f"network is {want}")
    return spec


def sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Loop:
    """The closed loop of rounds over one engine."""

    def __init__(self, engine, pool_host: np.ndarray, rng: np.random.Generator,
                 spans: devtrace.Spans, capture: check.Capture, devices):
        self.engine, self.pool, self.rng = engine, pool_host, rng
        self.spans, self.capture, self.devices = spans, capture, devices
        self.rounds = 0

    def round(self):
        """Serve one round; -> (order, rid of its first request, results)."""
        order = self.rng.permutation(len(self.pool))
        self.capture.round = self.rounds
        self.rounds += 1
        with self.spans.span("round.submit"):
            rids = [self.engine.submit(self.pool[i]) for i in order]
        with self.spans.span("round.drain"):
            res = self.engine.drain()
        return order, rids[0], res


def _profile(loop: Loop, n_rounds: int, devices) -> dict:
    from torch.profiler import ProfilerActivity, profile

    loop.spans.on = loop.spans.profiling = True
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_rounds):
            loop.round()
        sync(devices)
    loop.spans.profiling = False
    summary = devtrace.summarize(prof.events(), [d.index for d in devices])
    summary["spans"] = loop.spans.take()
    summary["images"] = n_rounds * len(loop.pool)
    return summary


@dataclasses.dataclass
class Window:
    """What the measured window saw: each request's latency and service
    time, the end of each round, the results of the rounds a kept forward
    belongs to, its wall seconds and the cards' energy."""
    latency_s: np.ndarray
    service_s: np.ndarray
    round_ends: list
    served: dict        # round -> (pool order, rid of its first request, results)
    wall_s: float
    energy_j: float | None
    spans: list


def serve_window(loop: Loop, seconds: float, cards, clock) -> Window:
    """Closed rounds until ``seconds`` have passed, then every card drained."""
    e0 = cards.energy_j() if cards else None
    t0 = clock()
    lat, svc, served, ends = [], [], {}, [t0]
    while clock() - t0 < seconds:
        order, rid0, res = loop.round()
        ends.append(clock())
        lat.append(np.fromiter((r.latency_s for r in res), float, len(res)))
        svc.append(np.fromiter((r.service_s for r in res), float, len(res)))
        served[loop.rounds - 1] = (order, rid0, res)
        live = {c["round"] for c in loop.capture.kept}
        served = {r: v for r, v in served.items() if r in live}
    sync(loop.devices)
    wall = clock() - t0
    energy_j = sum(cards.energy_j()) - sum(e0) if cards else None
    return Window(np.concatenate(lat), np.concatenate(svc), ends, served,
                  wall, energy_j, loop.spans.take())


def attach_served(kept: list, served: dict, pool: torch.Tensor,
                  classes: int) -> None:
    """Give each kept forward its rows' images (``pool_idx``, -1 where the
    staged row is no pool image) and the answers the engine returned for
    those requests (``served``, NaN where none came)."""
    n = pool.shape[0]
    for c in kept:
        c["pool_idx"] = check.match_rows(c["x"], pool)
        vals = np.full((c["x"].shape[0], classes), np.nan, np.float32)
        if c["round"] in served:
            order, rid0, res = served[c["round"]]
            rid_of = np.empty(n, np.int64)
            rid_of[order] = rid0 + np.arange(n)
            by_rid = {r.rid: r.value for r in res}
            for j, p in enumerate(c["pool_idx"].tolist()):
                if p >= 0 and int(rid_of[p]) in by_rid:
                    vals[j] = by_rid[int(rid_of[p])]
        c["served"] = torch.from_numpy(vals)


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, devices,
        t_process: float, clock=time.perf_counter) -> dict:
    """One run of ``cell`` on ``devices`` (one per chip, or the same device
    named several times on the CPU); -> the result line's dict, its
    ``check`` entry (last) holding each compared number beside its limit."""
    from repro_torch import api
    from repro_torch.launch.engine import CNNRunner, ServeEngine

    cfg, traffic = cell.config, cell.traffic
    devices = [torch.device(d) for d in devices]
    on_card = devices[0].type == "cuda"
    ref = reference_module(cfg)
    layers = ref.network(cfg)
    clients, max_batch = traffic["clients"], traffic["max_batch"]
    replica_batch = max_batch // len(devices)

    marks = [("process", t_process), ("imports", clock())]
    gen = inputs.generator(seed, devices[0])
    params = inputs.draw_params(layers, gen)
    pool = inputs.draw_pool(clients, cfg["img_hw"], cfg["in_channels"], gen)
    rng = np.random.default_rng(seed)
    spans = devtrace.Spans(clock)
    capture = check.Capture(rng, cell.check_forwards, cell.check_rows,
                            cfg["a_bits"])
    marks.append(("inputs", clock()))
    compiled = api.build(program_spec(cfg, layers), quant_config(cfg),
                         params=params, img_hw=cfg["img_hw"],
                         name=cfg["name"]).compile(
        target="cuda", batch_hints=(replica_batch,))
    engine = ServeEngine(HarnessRunner(CNNRunner(compiled.plan), spans,
                                       capture),
                         max_batch=max_batch,
                         flush_deadline_s=traffic["flush_deadline_s"],
                         mesh=tuple(devices) if len(devices) > 1 else None,
                         max_pending=max(4096, clients))
    loop = Loop(engine, pool.cpu().numpy(), rng, spans, capture, devices)
    cards, energy_note = (energy.open_cards(devices) if on_card
                          else (None, "no card"))
    marks.append(("compile", clock()))

    with check.observe_layers(capture):
        capture.keep_all = True       # the captures' memory, cached once
        for _ in range(WARM_ROUNDS):
            loop.round()
        sync(devices)
        marks.append(("warm", clock()))
        capture.reset()
        # what set-up made stays out of the window's full collections
        gc.collect()
        gc.freeze()
        for d in devices:
            if d.type == "cuda":
                torch.cuda.reset_peak_memory_stats(d)
        spans.on = trace
        setup_s = clock() - t_process
        try:
            win = serve_window(loop, seconds, cards, clock)
            capture.open = False
            prof = (_profile(loop, cell.profile_rounds, devices)
                    if trace and on_card else None)
        finally:
            gc.unfreeze()
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"), default=0)
    power_limit = cards.power_limit_w() if cards else None
    plan_layers = [(lp.engine, lp.fp) for lp in compiled.plan.layers]

    # the program's state goes before the reference runs
    kept = capture.kept
    del engine, compiled, loop, capture
    gc.collect()
    for d in devices:
        if d.type == "cuda":
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
    attach_served(kept, win.served, pool, cfg["classes"])
    numbers = check.compare(ref, params, cfg, kept, pool)
    attempted = (len(win.round_ends) - 1) * clients
    numbers["missing"] = attempted - len(win.latency_s)
    limits = cfg["limits"]

    result = dict(correct=check.verdict(numbers, limits),
                  attempted=attempted, failed=numbers["missing"],
                  device=dict(platform="gpu" if on_card else "cpu",
                              kind=(torch.cuda.get_device_name(devices[0])
                                    if on_card else "cpu"),
                              count=len(devices), memory_peak_bytes=int(peak),
                              power_limit_w=power_limit))
    if not trace:
        metrics = yardstick.end_to_end(win.latency_s, win.wall_s, setup_s,
                                       win.energy_j)
    else:
        ctx = dict(cfg=cfg, traffic=traffic, layers=layers,
                   plan_layers=plan_layers, chips=len(devices),
                   replica_batch=replica_batch, spans=win.spans,
                   service_s=win.service_s, latency_s=win.latency_s,
                   profile=prof)
        metrics = {name: (v, unit) for name, unit, reader in cell.metrics
                   if (v := reader.read(ctx)) is not None}
        if prof:
            result["device"].update(busy_s=float(np.mean(prof["busy_s"])),
                                    window_s=prof["window_s"])
            result["breakdown"] = breakdown(prof, len(devices))
    result["metrics"] = {k: dict(value=float(v), unit=u)
                         for k, (v, u) in metrics.items()}
    round_ms = 1e3 * np.diff(win.round_ends)
    result["window"] = dict(
        seconds=win.wall_s, rounds=len(round_ms), images=len(win.latency_s),
        round_ms_quartiles=np.percentile(round_ms, [0, 25, 50, 75, 100])
        .tolist(),
        slowest_round=int(np.argmax(round_ms)),
        setup_s={b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])},
        energy_source=("nvml_total_energy" if cards
                       else f"none ({energy_note})"),
        flips_by_layer=numbers["flips_by_layer"])
    result["check"] = {k: dict(value=numbers[k], limit=limits[k])
                       for k in check.NUMBERS}
    return result


def breakdown(prof: dict, chips: int) -> dict:
    """The traced slice's ten device operations that took most time and
    its idle seconds by the host span, per card."""
    merged: dict = {}
    for k, (sec, _) in prof["by_kernel"].items():
        label = yardstick.kernel_label(k)
        merged[label] = merged.get(label, 0.0) + sec / chips
    top = sorted(merged.items(), key=lambda t: -t[1])[:10]
    idle = sorted(((f"idle in {k}", v / chips)
                   for k, v in prof["idle_by_span"].items()),
                  key=lambda t: -t[1])[:10]
    return dict(device_ops=[list(t) for t in top],
                idle_gaps=[list(t) for t in idle])
