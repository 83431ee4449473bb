"""The share of the positions that K1's wide-window route walked and that
passed its hop budget, so swept the rest of their distances: the program's
own ``EncodeStats.match_positions`` and ``match_fallbacks``
(``ops/match.py::match_chain_plain``, ``csrc/match_chain.cu``: counted on
the device, brought back in each batch's (total, exit) fetch), summed over
the window's compress calls, as 100 x fallbacks / positions, in %.  Read by
attribute: None where the program keeps no such counter, or where no
position was walked (a window below the route's)."""


def read(run):
    walked = fell = 0
    for c in run.calls_of("compress"):
        positions = getattr(c.stats, "match_positions", None)
        fallbacks = getattr(c.stats, "match_fallbacks", None)
        if positions is None or fallbacks is None:
            return None
        walked += positions
        fell += fallbacks
    return 100 * fell / walked if walked else None
