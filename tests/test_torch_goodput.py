"""The port's goodput ledger (the part the trainer's resize calls) held
against the JAX package's on the same clock and the same calls."""

import pytest

from edl_tpu.observability import goodput as jgoodput
from edl_tpu_torch.observability import goodput


class Clock:
    def __init__(self) -> None:
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def _both(**kw):
    clocks = Clock(), Clock()
    return ((goodput.GoodputLedger(clock=clocks[0], **kw), clocks[0]),
            (jgoodput.GoodputLedger(clock=clocks[1], **kw), clocks[1]))


def test_phase_names_are_the_reference_names():
    assert goodput.ALL_PHASES == jgoodput.ALL_PHASES
    assert (goodput.COMPILE, goodput.RESHARD, goodput.PRODUCTIVE) == (
        jgoodput.COMPILE, jgoodput.RESHARD, jgoodput.PRODUCTIVE)


def test_resize_attribution_matches_the_reference():
    """The calls a resize makes — spans at the old world size, then the
    new size — leave both ledgers with the same chip-seconds."""
    script = [("tick", 3.0), ("span", goodput.COMPILE, 0.5, 2),
              ("span", goodput.RESHARD, 0.25, 2), ("world", 4),
              ("tick", 2.0), ("span", goodput.RESHARD, 100.0, None),
              ("world", 1), ("tick", 1.5), ("span", goodput.PRODUCTIVE,
                                            1.0, None)]
    (port, pc), (ref, rc) = _both(job="j", world_size=2,
                                 base_phase=goodput.PRODUCTIVE)
    moves = []
    for op in script:
        if op[0] == "tick":
            pc.t += op[1]
            rc.t += op[1]
        elif op[0] == "world":
            port.set_world_size(op[1])
            ref.set_world_size(op[1])
        else:
            moves.append(port.note_span(op[1], op[2], world_size=op[3]))
            assert moves[-1] == ref.note_span(op[1], op[2],
                                              world_size=op[3])
    for phase in goodput.ALL_PHASES:
        assert port.chip_seconds(phase) == ref.chip_seconds(phase), phase
    assert port.world_size == ref.world_size == 1
    assert port.conserves() and port.conservation_error() == \
        ref.conservation_error()
    # a span larger than the source phase moves what exists and no more
    # (3 s at 2 less the spans, then 2 s at 4); a span into the accruing
    # phase moves nothing
    assert moves == [1.0, 0.5, 6.0 - 1.5 + 8.0, 0.0]
    assert port.chip_seconds(goodput.PRODUCTIVE) == 1.5


def test_unknown_phase_raises():
    with pytest.raises(ValueError):
        goodput.GoodputLedger(base_phase="nap")
    with pytest.raises(ValueError):
        goodput.GoodputLedger().note_span("nap", 1.0)


def test_process_helpers_are_no_ops_without_a_ledger():
    goodput.set_process_ledger(None)
    goodput.note_span(goodput.COMPILE, 1.0)
    goodput.set_world_size(3)
    assert goodput.get_process_ledger() is None
    clock = Clock()
    led = goodput.set_process_ledger(goodput.GoodputLedger(
        world_size=2, base_phase=goodput.PRODUCTIVE, clock=clock))
    try:
        assert goodput.get_process_ledger() is led
        clock.t += 1.0
        goodput.note_span(goodput.COMPILE, 0.5, world_size=2)
        goodput.note_span("nap", 1.0)  # swallowed: accounting never raises
        goodput.set_world_size(3)
        assert led.chip_seconds(goodput.COMPILE) == 1.0
        assert led.chip_seconds(goodput.PRODUCTIVE) == 1.0
        assert led.world_size == 3
    finally:
        goodput.set_process_ledger(None)
