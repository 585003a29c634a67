"""engine.slot_wait_share: the share of the measured window's dispatches
whose copy to the card found its landing slot still held by a forward the
card had not finished, in %: the value of the program's `engine.stage`
phase inside each dispatch is 1 then (the copy waits on the engine's copy
stream), else 0. High where the card sets the pace, since the host then
runs two forwards ahead. None where the program's phases carry no value
(its `annotate` has no `phase_value`: a program without landing slots), or
where a window dispatch has no `engine.stage` left in the ring
(`harness/program_spans.py`)."""

from benchmark.harness.program_spans import dispatches, recorder


def _phases_carry_values() -> bool:
    try:
        from vqa_tpu_torch.utils import profiling
    except ImportError:
        return False
    return hasattr(getattr(profiling, "annotate", None), "phase_value")


def read(rec):
    ds = dispatches(rec)
    if ds is None or not _phases_carry_values():
        return None
    ids = {d.id for d in ds}
    stages = [r for r in recorder()("engine.stage")[0] if r.parent in ids]
    if {r.parent for r in stages} != ids:
        return None
    return 100.0 * sum(r.value == 1 for r in stages) / len(ds)
