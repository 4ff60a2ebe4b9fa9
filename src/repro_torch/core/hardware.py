"""Chiplet Cloud hardware model (paper §3, §4.1, Table 1).

Models a single accelerator chiplet (CC-MEM SRAM + SIMD compute + chip IO),
the 1U server that carries lanes of chiplets, and their fabrication cost
(yield-aware die cost via the negative-binomial model).

All constants trace to Table 1 of the paper or are calibrated against the
Table 2 design points (see tests/test_core_engine.py):
  * compute density 2.65 mm^2/TFLOPS, power 1.3 W/TFLOPS, <1 W/mm^2
  * SRAM macro density ~2.0 MB/mm^2 at 7nm (calibrated: Table 2 die sizes)
  * wafer $10,000 (300mm), defect density 0.1/cm^2
  * chip IO 25 GB/s x 4 links; 8 lanes/server; <=20 chips, <=6000 mm^2,
    <=250 W per lane; 100GbE $450; PSU/DCDC efficiency 0.95
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

# --- Table 1 constants -----------------------------------------------------
TECH = "7nm"
WAFER_COST = 10_000.0  # $
WAFER_DIAMETER_MM = 300.0
DEFECT_DENSITY_MM2 = 0.1 / 100.0  # 0.1 per cm^2
YIELD_ALPHA = 4.0  # cluster parameter
DIE_TEST_COST = 2.0  # $/die (assumption, documented)

COMPUTE_MM2_PER_TFLOP = 2.65
POWER_W_PER_TFLOP = 1.3
MAX_POWER_DENSITY_W_MM2 = 1.0

SRAM_MB_PER_MM2 = 2.0  # calibrated against Table 2 (see module docstring)
SRAM_LEAKAGE_W_PER_MB = 0.5e-3
SRAM_PJ_PER_BYTE = 1.0  # access energy (12nm->7nm scaled, conservative)
# CC-MEM crossbar: routing rides over the SRAM arrays (NoC symbiosis), but
# decoder + bank control still cost area that grows with the bank count.
CCMEM_AREA_OVERHEAD_BASE = 0.08
CCMEM_BW_PER_MB_BASE = 16.0e9  # bytes/s per MB at the base bank ratio

CHIP_IO_LINKS = 4
CHIP_IO_GBS = 25.0e9  # bytes/s per link
AUX_AREA_MM2 = 4.0  # PHYs, controller, misc per chip

LANES_PER_SERVER = 8
MAX_CHIPS_PER_LANE = 20
MAX_SILICON_PER_LANE_MM2 = 6000.0
MAX_POWER_PER_LANE_W = 250.0
PSU_EFFICIENCY = 0.95
DCDC_EFFICIENCY = 0.95
ETHERNET_COST = 450.0  # 100GbE
SERVER_LIFE_YEARS = 1.5

# Server bill-of-materials assumptions (documented; ASIC Clouds-style).
PCB_COST = 400.0
CONTROLLER_COST = 150.0  # FPGA/uC dispatcher
PSU_COST_PER_W = 0.12
HEATSINK_COST_PER_CHIP = 6.0
FAN_COST = 18.0  # per lane
PACKAGE_BASE_COST = 3.0  # organic substrate, per chip
PACKAGE_COST_PER_MM2 = 0.01


@dataclass(frozen=True)
class ChipConfig:
    """One chiplet design point."""

    die_mm2: float
    sram_mb: float
    tflops: float
    bw_ratio: float = 1.0  # CC-MEM bank-group ratio knob (x base bw/MB)

    # -- derived ------------------------------------------------------------
    @property
    def mem_bw(self) -> float:
        """CC-MEM aggregate bandwidth, bytes/s."""
        return self.sram_mb * CCMEM_BW_PER_MB_BASE * self.bw_ratio

    @property
    def compute_area(self) -> float:
        return self.tflops * COMPUTE_MM2_PER_TFLOP

    @property
    def mem_area(self) -> float:
        # Higher bank ratios cost decoder/control area (crossbar routing is
        # absorbed above the arrays — NoC symbiosis [36]).
        overhead = CCMEM_AREA_OVERHEAD_BASE * self.bw_ratio
        return self.sram_mb / SRAM_MB_PER_MM2 * (1.0 + overhead)

    @property
    def used_area(self) -> float:
        return self.compute_area + self.mem_area + AUX_AREA_MM2

    @property
    def tdp(self) -> float:
        compute = self.tflops * POWER_W_PER_TFLOP
        mem = (self.sram_mb * SRAM_LEAKAGE_W_PER_MB
               + self.mem_bw * SRAM_PJ_PER_BYTE * 1e-12)
        return compute + mem

    def feasible(self) -> bool:
        return (
            20.0 <= self.die_mm2 <= 800.0
            and self.used_area <= self.die_mm2
            and self.tdp / self.die_mm2 <= MAX_POWER_DENSITY_W_MM2
            and self.tflops > 0
            and self.sram_mb > 0
        )

    # -- fabrication cost ----------------------------------------------------
    def dies_per_wafer(self) -> int:
        d = WAFER_DIAMETER_MM
        a = self.die_mm2
        return max(1, int(math.pi * (d / 2) ** 2 / a
                          - math.pi * d / math.sqrt(2 * a)))

    def die_yield(self) -> float:
        return (1.0 + self.die_mm2 * DEFECT_DENSITY_MM2 / YIELD_ALPHA) ** (
            -YIELD_ALPHA)

    def die_cost(self) -> float:
        return (WAFER_COST / self.dies_per_wafer() + DIE_TEST_COST) \
            / self.die_yield()

    def packaged_cost(self) -> float:
        return self.die_cost() + PACKAGE_BASE_COST \
            + PACKAGE_COST_PER_MM2 * self.die_mm2


@dataclass(frozen=True)
class ServerConfig:
    """A 1U Chiplet Cloud server: lanes of chiplets on a 2D torus PCB."""

    chip: ChipConfig
    chips_per_lane: int
    lanes: int = LANES_PER_SERVER

    @property
    def num_chips(self) -> int:
        return self.chips_per_lane * self.lanes

    @property
    def silicon_per_lane(self) -> float:
        return self.chip.die_mm2 * self.chips_per_lane

    @property
    def power_per_lane(self) -> float:
        return self.chip.tdp * self.chips_per_lane

    @property
    def tdp(self) -> float:
        chips = self.chip.tdp * self.num_chips
        # controller+fans ~30W; PSU/DCDC losses on top.
        return (chips + 30.0) / (PSU_EFFICIENCY * DCDC_EFFICIENCY)

    @property
    def sram_mb(self) -> float:
        return self.chip.sram_mb * self.num_chips

    @property
    def tflops(self) -> float:
        return self.chip.tflops * self.num_chips

    def feasible(self) -> bool:
        return (
            self.chip.feasible()
            and 1 <= self.chips_per_lane <= MAX_CHIPS_PER_LANE
            and self.silicon_per_lane <= MAX_SILICON_PER_LANE_MM2
            and self.power_per_lane <= MAX_POWER_PER_LANE_W
        )

    def capex(self) -> float:
        chips = self.chip.packaged_cost() * self.num_chips
        psu = PSU_COST_PER_W * self.tdp
        heatsinks = HEATSINK_COST_PER_CHIP * self.num_chips
        fans = FAN_COST * self.lanes
        return (chips + psu + heatsinks + fans + PCB_COST
                + CONTROLLER_COST + ETHERNET_COST)


def sweep_chips(
    die_sizes=None, mem_fracs=None, bw_ratios=(0.5, 1.0, 2.0, 4.0),
) -> List[ChipConfig]:
    """Phase-1 chip enumeration: every (die, memory split, bank ratio)."""
    die_sizes = die_sizes or [20, 40, 60, 80, 100, 120, 140, 160, 200, 240,
                              280, 320, 400, 480, 560, 640, 720, 800]
    mem_fracs = mem_fracs or [0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]
    out = []
    for die in die_sizes:
        budget = die - AUX_AREA_MM2
        for mf in mem_fracs:
            for r in bw_ratios:
                mem_area = budget * mf
                sram = mem_area * SRAM_MB_PER_MM2 / (
                    1.0 + CCMEM_AREA_OVERHEAD_BASE * r)
                tflops = (budget - mem_area) / COMPUTE_MM2_PER_TFLOP
                c = ChipConfig(die_mm2=die, sram_mb=sram, tflops=tflops,
                               bw_ratio=r)
                if c.feasible():
                    out.append(c)
    return out


def sweep_servers(chips: Optional[List[ChipConfig]] = None) -> List[ServerConfig]:
    """Phase-1 server enumeration with floorplan/power/thermal limits."""
    chips = chips or sweep_chips()
    out = []
    for c in chips:
        max_by_si = int(MAX_SILICON_PER_LANE_MM2 // c.die_mm2)
        max_by_pw = int(MAX_POWER_PER_LANE_W // max(c.tdp, 1e-9))
        top = min(MAX_CHIPS_PER_LANE, max_by_si, max_by_pw)
        # Enumerate a few packing densities, not just the max.
        for n in sorted({top, max(1, top // 2), max(1, top // 4)}):
            s = ServerConfig(chip=c, chips_per_lane=n)
            if s.feasible():
                out.append(s)
    return out
