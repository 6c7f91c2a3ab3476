"""ba_solve_ms.seq: per sequence, the device intervals of the `ba.solve`
spans (each window's run_ba replay and its read-back), summed, in ms; the
median over the window's sequences."""

from vobench import programspans


def read(run):
    return programspans.median_per_sequence(run, lambda g: programspans.device_ms(g, ("ba.solve",)))
