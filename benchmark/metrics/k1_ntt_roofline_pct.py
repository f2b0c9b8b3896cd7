"""k1_ntt_roofline_pct: K1's bound over its device time, both summed over
the profiled proves; the bound counts each NTT call a prove makes
(work.ntt_calls) at the frozen per-operation counts and H100 peaks."""

import work
from readers import K1_NAMES, roofline_pct


def read(record: dict):
    return roofline_pct(record, "ntt", K1_NAMES,
                        lambda s, prof: work.ntt_bound_ms(s) * prof["requests"],
                        lambda s, prof: work.ntt_launches(s) * prof["requests"])
