"""The scatter's cut of the channels over CTAs (nep_compact.scatter_plan),
on the CPU: the choice it makes for the plans the port runs, and the
windows it refuses.

The plans are those chip_smoke.py prints (PERF.md section 4): PbTe 32,768
(jittered and lattice), 262,144 and 1,000,000 on the default rung, the
1,728-atom windows plan of the measure phase's modal deck, Si 32,768 and
1,000,000, and Si 4,096 at cap 320 (Tersoff's contract route).  Two
channels a CTA where 2 divides pch and their accumulator leaves 8 CTAs of
256 threads an SM (at most 28,160 B: 228 KB an SM, 1 KB reserved a CTA),
else 1; 16-byte units where a_pad and wl are multiples of 4 and the bases
aligned.  The kernel before the cut held all pch channels in one
CTA and refused 4 * pch * wl > 232,448 B; the cut admits every window up
to one channel's 232,448 B (wl 58,112), so more than it did.
"""

import pytest

from gpumd_tpu_torch.engine import nep_compact as TC
from gpumd_tpu_torch.engine.grid import DenseGridPlan


def _plan(grid, cap, bx, mn_a=32, cl=0):
    base = DenseGridPlan(grid=grid, cap=cap, rc=8.0, skin=1.5,
                         pbc=(True, True, True))
    return TC.CompactPlan(base=base, bx=bx, mn_r=max(mn_a, 32), mn_a=mn_a,
                          cl=cl)


# name: (grid, cap, bx, cl, nb, wl) as chip_smoke.py prints them, and
# the channels a CTA the plan takes
PLANS = {
    "pbte32k_jittered": ((8, 11, 11), 56, 2, 1280, 484, 2048, 2),
    "pbte32k_lattice": ((8, 11, 11), 64, 2, 1280, 484, 2304, 2),
    "pbte262k": ((16, 22, 22), 64, 2, 1280, 3872, 2304, 2),
    "pbte1m": ((24, 34, 34), 64, 2, 1408, 13872, 2304, 2),
    "pbte1728_windows": ((4, 4, 4), 40, 2, 0, 32, 1536, 2),
    "si32k": ((16, 21, 21), 16, 8, 0, 882, 1536, 2),
    "si1m": ((56, 67, 67), 8, 14, 0, 17956, 1152, 2),
}


@pytest.mark.parametrize("pch", [4, 12])
@pytest.mark.parametrize("name", list(PLANS))
def test_scatter_plan_of_the_ports_plans(name, pch):
    grid, cap, bx, cl, nb, wl, group = PLANS[name]
    cp = _plan(grid, cap, bx, cl=cl)
    assert (cp.nb, cp.wl) == (nb, wl)
    sp = TC.scatter_plan(cp.nb, pch, cp.wl, cp.a_pad)
    assert sp == TC.ScatterPlan(vec=4, group=group, groups=pch // group,
                                smem=4 * group * wl, ctas=nb * pch // group)
    assert 8 * (sp.smem + 1024) <= 233472  # 8 CTAs an SM
    assert sp.entry == f"14scatter_kernelILi4ELi{group}E"


@pytest.mark.parametrize("pch,group", [(4, 1), (12, 1)])
def test_scatter_plan_cuts_wide_windows_to_fewer_channels(pch, group):
    """Si 4,096 at cap 320 (wl 8,704): even one channel (34,816 B) leaves
    fewer than 8 CTAs an SM, so one channel a CTA; the kernel before the
    cut refused 12 channels there (417,792 B)."""
    cp = _plan((10, 10, 10), 320, 1)
    assert cp.wl == 8704
    sp = TC.scatter_plan(cp.nb, pch, cp.wl, cp.a_pad)
    assert (sp.group, sp.groups, sp.smem, sp.ctas) == (
        group, pch // group, 4 * group * 8704, cp.nb * pch // group)
    # the kernel before the cut: all channels in one CTA
    assert (4 * pch * cp.wl <= TC._SMEM_LIMIT) == (pch == 4)


@pytest.mark.parametrize("wl,group", [(128, 2), (3456, 2), (3520, 2),
                                      (3584, 1), (7040, 1), (14464, 1)])
def test_scatter_plan_takes_fewer_channels_past_the_target(wl, group):
    """2 channels up to 28,160 B (wl 3,520), 1 past it (and past the
    target: 8 CTAs an SM cannot be had)."""
    assert TC.scatter_plan(10, 12, wl, 128).group == group


@pytest.mark.parametrize("pch,wl,group", [(1, 1536, 1), (2, 1536, 2),
                                          (3, 1536, 1), (5, 1536, 1),
                                          (6, 1536, 2), (8, 2304, 2),
                                          (9, 2304, 1), (16, 3584, 1)])
def test_scatter_plan_other_channel_counts(pch, wl, group):
    """The group divides pch: each CTA holds a whole group."""
    sp = TC.scatter_plan(7, pch, wl, 128)
    assert (sp.group, sp.groups, sp.ctas) == (group, pch // group,
                                              7 * pch // group)


@pytest.mark.parametrize("a_pad,wl,aligned", [(130, 2304, True),
                                              (128, 2306, True),
                                              (128, 2304, False)])
def test_scatter_plan_takes_4_byte_units_where_16_do_not_fit(a_pad, wl,
                                                             aligned):
    assert TC.scatter_plan(4, 12, wl, a_pad, aligned).vec == 1


def test_scatter_plan_refuses_a_window_past_shared_memory():
    """The widest window one channel's accumulator holds is wl 58,112
    (232,448 B); one 128-lane group more is refused."""
    sp = TC.scatter_plan(2, 12, 58112, 2176)
    assert (sp.group, sp.smem) == (1, TC._SMEM_LIMIT)
    for wl in (58240, 1 << 20):
        with pytest.raises(ValueError, match="exceeds shared memory"):
            TC.scatter_plan(2, 4, wl, 128)
