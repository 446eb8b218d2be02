"""The decoder's and the loss's share of the device time, from the
program's spans in the profiled stretch. Training: ``model.decoder``,
``train.loss`` and ``train.backward.head`` (their backward) over
``train.update``. Scoring: ``model.decoder`` over ``model.forward``."""

from pfnbench import spans

PARTS = {"train": ({"model.decoder", "train.loss", "train.backward.head"}, {"train.update"}),
         "score": ({"model.decoder"}, {"model.forward"})}


def read(t: dict):
    recorded = spans.program_spans()
    if recorded is None or t.get("kind") not in PARTS:
        return None
    part, whole = (spans.device_ms(recorded, names) for names in PARTS[t["kind"]])
    return 100.0 * part / whole if part is not None and whole else None
