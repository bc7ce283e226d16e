"""Entry kind ``pipelined_plans``: the port's pipelined plan runner,
``pymodem_tpu_torch.runtime.bank.run_plans_banked_pipelined``, the path of
the CLI's multi-file route and the decode server's batch
(``cli.run_decode_batch``), on the default device codec at float32.

One client hands the runner one batch of jobs (the configuration's plan
with one recording each) and waits for its ``RunResult``s before it sends
the next: a closed loop.
"""

from __future__ import annotations

import contextlib
import time

import torch

from pymodem_tpu_torch.config import ReportSpec, RunPlan, build_chain_spec
from pymodem_tpu_torch.dsp import fir
from pymodem_tpu_torch.runtime import bank

# the functions of the port that the traced run wraps in spans: the
# runner's stages, and the FIRs' banded matmuls (``dsp/fir._matmul``,
# called through the module's globals by every FIR engine of the port)
SPANS = {"submit": (bank, "_submit_banked"), "drain": (bank, "_drain"),
         "finish_plan": (bank, "_finish_plan"), "fir": (fir, "_matmul")}


class Entry:
    def __init__(self, config: dict, mix: dict, recordings: list, device):
        self.rate = float(config["sample_rate"])
        lines = config["lines"]
        self.plan = RunPlan(
            chains=tuple(build_chain_spec(self.rate, line) for line in lines
                         if line.get("object_type") == "demod_chain"),
            reports=tuple(
                ReportSpec(name=line.get("object_name", "report"),
                           style=line.get("options", {}).get("style", "raw"))
                for line in lines if line.get("object_type") == "report"))
        self.kw = dict(config.get("entry", {}))
        self.depth = int(mix.get("depth", 1))
        self.recordings = recordings
        self.device = torch.device(device)

    def run(self, indices: list[int]) -> list:
        """RunResults of one batch, one job per recording index."""
        return bank.run_plans_banked_pipelined(
            [(self.plan, self.recordings[i], self.rate) for i in indices],
            depth=self.depth, device=self.device, **self.kw)

    @staticmethod
    def chain_packets(result) -> list[list]:
        """Per chain, in config order: [(bytes, stream address,
        bytes corrected)] of every packet the chain decoded."""
        return [[(tuple(int(v) for v in p.data), int(p.streamaddress),
                  int(p.bytes_corrected)) for p in chain]
                for chain in result.aggregate.chains]

    @staticmethod
    def reports(result) -> list[str]:
        return list(result.reports)

    @contextlib.contextmanager
    def spans(self, record):
        """Wrap the runner's stages in spans: a ``torch.profiler`` range
        each, and ``record(name, seconds)`` with its host time."""
        saved = {name: getattr(mod, attr) for name, (mod, attr) in SPANS.items()}

        def wrap(name, fn):
            def inner(*args, **kwargs):
                t0 = time.perf_counter()
                with torch.profiler.record_function(f"portbench.{name}"):
                    out = fn(*args, **kwargs)
                record(name, time.perf_counter() - t0)
                return out
            return inner

        for name, (mod, attr) in SPANS.items():
            setattr(mod, attr, wrap(name, saved[name]))
        try:
            yield
        finally:
            for name, (mod, attr) in SPANS.items():
                setattr(mod, attr, saved[name])
