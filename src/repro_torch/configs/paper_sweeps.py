"""Table 2: layer and implementation parameters for the paper's analysis.

A star in the paper marks the swept parameter; here each configuration is a
dict of constants plus the name + range of the swept axis.  SIMD types
sweep over the three datapaths of Fig. 4 in every configuration.

A copy of the JAX package's ``configs/paper_sweeps.py`` (constants and
plain Python, no framework): the port keeps its own so it imports with
torch alone, and a test holds the two equal.
"""

CONFIGURATIONS = {
    1: dict(sweep="ifm_ch", values=[2, 4, 8, 16, 32, 64],
            ifm_dim=32, ofm_ch=64, kernel=4, pe=2, simd=2),
    2: dict(sweep="ifm_dim", values=[4, 8, 16],
            ifm_ch=64, ofm_ch=64, kernel=4, pe=32, simd=32),
    3: dict(sweep="ofm_ch", values=[2, 4, 8, 16, 32, 64],
            ifm_ch=64, ifm_dim=32, kernel=4, pe=2, simd=2),
    4: dict(sweep="kernel", values=[3, 5, 7, 9],
            ifm_ch=64, ifm_dim=32, ofm_ch=64, pe=32, simd=32),
    5: dict(sweep="pe", values=[2, 4, 8, 16, 32, 64],
            ifm_ch=64, ifm_dim=8, ofm_ch=64, kernel=4, simd=64),
    6: dict(sweep="simd", values=[2, 4, 8, 16, 32, 64],
            ifm_ch=64, ifm_dim=8, ofm_ch=64, kernel=4, pe=64),
}

# Table 3: larger designs with increasing IFM channels (PE = SIMD = 16)
LARGE_CONFIGS = [
    dict(ifm_ch=16, ifm_dim=16, ofm_ch=16, kernel=4, pe=16, simd=16),
    dict(ifm_ch=32, ifm_dim=16, ofm_ch=16, kernel=4, pe=16, simd=16),
    dict(ifm_ch=64, ifm_dim=16, ofm_ch=16, kernel=4, pe=16, simd=16),
]

SIMD_TYPES = ("xnor", "binary", "standard")


def mvu_shape(c: dict) -> tuple[int, int, int]:
    """(N, K, n_pixels) of the MVU behind a conv with these parameters."""
    k = c["kernel"] ** 2 * c["ifm_ch"]
    n = c["ofm_ch"]
    od = c["ifm_dim"] - c["kernel"] + 1  # stride 1, no pad (paper setup)
    return n, k, max(od, 1) ** 2


def expand(cfg_id: int):
    """Yield (params_dict, swept_value) rows for one configuration."""
    c = CONFIGURATIONS[cfg_id]
    base = {k: v for k, v in c.items() if k not in ("sweep", "values")}
    for v in c["values"]:
        row = dict(base)
        row[c["sweep"]] = v
        row.setdefault("ifm_ch", 64)
        row.setdefault("ifm_dim", 32)
        row.setdefault("ofm_ch", 64)
        row.setdefault("kernel", 4)
        row.setdefault("pe", 2)
        row.setdefault("simd", 2)
        yield row, v
