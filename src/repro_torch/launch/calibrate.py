"""Fit the profiler's H100 knobs to stage times measured on the card.

  PYTHONPATH=src python -m repro_torch.launch.calibrate chiprun_out/stage_times.json

The input is the JSON list ``chip_smoke.py`` writes after its serve phases:
one reading per served request and stage, ``{"pipeline", "resolution",
"seconds", "num_steps", "stage", "ms"}``, each stage on one chip after an
untimed run at its shape (``num_steps``: the DDIM steps its Diffuse ran,
fewer than the config's for a heavy class cut to one step; the prediction is
scaled to them, and only readings of whole requests are fitted). Fitted,
by least squares on log(predicted / measured):

* ``mfu`` and ``seq_mfu_knee`` to the Diffuse readings of ``FIT_DIFFUSE``
  (sd3 at 512 px is left out: its Diffuse is host-bound and moves between
  runs of one tree);
* ``mfu_conv`` to the image Decode readings of ``FIT_DECODE``. The video
  Decode readings are not fitted: the cost model prices a production 3D
  video decoder, the port's decoder is 2D per frame.

Encode is not fitted either: its readings are the port's eager host time,
which ``dispatch_overhead`` would add to every stage. That knob, the
host<->device bandwidth and the communicator build are measured on the card
machine by ``chip_smoke.py`` (phase 5c). The fit starts from ``H100_SXM``
and prints the fitted knobs and every reading's prediction under them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
from typing import Dict, List, Sequence, Tuple

import repro_torch.configs as C
from repro_torch.core.profiler import H100_SXM, Hardware, Profiler
from repro_torch.core.request import Request
from repro_torch.launch import quickstart

# (pipeline, resolution, seconds) of the readings each knob is fitted to
FIT_DIFFUSE = (("sd3", 1024, 0.0), ("sd3", 1536, 0.0), ("flux", 512, 0.0),
               ("flux", 1024, 0.0), ("cogvideox", 480, 2.0),
               ("hunyuanvideo", 540, 1.0))
FIT_DECODE = (("sd3", 512, 0.0), ("sd3", 1024, 0.0), ("sd3", 1536, 0.0),
              ("flux", 512, 0.0), ("flux", 1024, 0.0))
# every fitted Diffuse reading must lie in this band times its prediction
BAND = (0.7, 1.3)
COND_LEN = 77


def _key(r: Dict) -> Tuple[str, int, float]:
    return (r["pipeline"], int(r["resolution"]), float(r["seconds"]))


def predict_ms(hw: Hardware, pipeline: str, resolution: int, seconds: float,
               stage: str, num_steps=None) -> float:
    """The profiler's time for one request's stage on one chip, its Diffuse
    cut to ``num_steps`` DDIM steps where given."""
    prof = Profiler(C.get(pipeline), hw=hw)
    req = Request(pipeline, resolution, seconds, cond_len=COND_LEN)
    return quickstart.predicted_ms(prof, req, stage, prof.k_min, num_steps)


def _predict(hw: Hardware, r: Dict) -> float:
    return predict_ms(hw, *_key(r), r["stage"], r.get("num_steps"))


def _log_sq(hw: Hardware, readings: Sequence[Dict]) -> float:
    return sum(math.log(_predict(hw, r) / r["ms"]) ** 2 for r in readings)


def _select(readings: Sequence[Dict], stage: str, keys) -> List[Dict]:
    """The readings of whole requests of ``keys`` at ``stage``."""
    want = set(keys)
    return [r for r in readings if r["stage"] == stage and _key(r) in want
            and r.get("num_steps", C.get(r["pipeline"]).num_steps)
            == C.get(r["pipeline"]).num_steps]


def _argmin(f, lo: float, hi: float, steps: int = 48, rounds: int = 6) -> float:
    """Grid search on [lo, hi], refined around the best point: the
    objectives here are smooth in one variable, and a grid keeps the fit
    deterministic and free of solver libraries."""
    for _ in range(rounds):
        xs = [lo + (hi - lo) * i / steps for i in range(steps + 1)]
        best = min(xs, key=f)
        span = (hi - lo) / steps
        lo, hi = max(lo, best - span), min(hi, best + span)
    return best


def fit(readings: Sequence[Dict], hw: Hardware = H100_SXM) -> Hardware:
    """``hw`` with ``mfu``, ``seq_mfu_knee`` and ``mfu_conv`` fitted."""
    diffuse = _select(readings, "D", FIT_DIFFUSE)
    decode = _select(readings, "C", FIT_DECODE)
    if len(diffuse) != len(FIT_DIFFUSE) or len(decode) != len(FIT_DECODE):
        raise ValueError(f"need readings of Diffuse {FIT_DIFFUSE} and Decode {FIT_DECODE}")

    def best_mfu(knee: int) -> float:
        return math.exp(_argmin(lambda lm: _log_sq(dataclasses.replace(
            hw, mfu=math.exp(lm), seq_mfu_knee=knee), diffuse), math.log(0.05), 0.0))

    knee = int(round(_argmin(lambda k: _log_sq(dataclasses.replace(
        hw, mfu=best_mfu(int(round(k))), seq_mfu_knee=int(round(k))), diffuse),
        0.0, 4096.0, steps=32, rounds=4)))
    out = dataclasses.replace(hw, mfu=round(best_mfu(knee), 4), seq_mfu_knee=knee)
    lc = _argmin(lambda lm: _log_sq(dataclasses.replace(out, mfu_conv=math.exp(lm)), decode),
                 math.log(0.01), 0.0)
    return dataclasses.replace(out, mfu_conv=round(math.exp(lc), 4))


def table(hw: Hardware, readings: Sequence[Dict]) -> List[Dict]:
    """Each reading with its prediction under ``hw``, their ratio, and
    whether the reading is one a knob was fitted to."""
    fitted = {id(r) for stage, keys in (("D", FIT_DIFFUSE), ("C", FIT_DECODE))
              for r in _select(readings, stage, keys)}
    out = []
    for r in readings:
        pred = _predict(hw, r)
        out.append(dict(r, predicted_ms=pred, measured_over_predicted=r["ms"] / pred,
                        fitted=id(r) in fitted))
    return out


def outside_band(hw: Hardware, readings: Sequence[Dict]) -> List[Dict]:
    """The fitted Diffuse readings outside ``BAND`` x their prediction."""
    return [row for row in table(hw, _select(readings, "D", FIT_DIFFUSE))
            if not BAND[0] <= row["measured_over_predicted"] <= BAND[1]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("readings", help="stage-time JSON written by chip_smoke.py")
    args = ap.parse_args(argv)
    with open(args.readings) as f:
        readings = json.load(f)
    hw = fit(readings)
    print(f"fitted from {len(readings)} readings: mfu={hw.mfu} "
          f"seq_mfu_knee={hw.seq_mfu_knee} mfu_conv={hw.mfu_conv}")
    for row in table(hw, readings):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
