"""TCO model (paper §4.2, following Barroso et al. warehouse-scale model).

TCO = CapEx + Life x OpEx, expressed here as a $/second rate per server so
TCO/token = rate x servers / throughput.

Assumptions (documented constants): electricity $0.07/kWh, PUE 1.1,
datacenter CapEx $11/W amortized over 12 years, server life 1.5 years
(Table 1), average power = 75% TDP while serving.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.hardware import SERVER_LIFE_YEARS, ServerConfig

ELECTRICITY_PER_KWH = 0.07
PUE = 1.1
DC_CAPEX_PER_W = 11.0
DC_AMORT_YEARS = 12.0
AVG_POWER_FRACTION = 0.75
MAINTENANCE_FRACTION = 0.05  # of server CapEx per year

SECONDS_PER_YEAR = 365.25 * 24 * 3600.0

# NRE model (paper §6.4, extended from Moonwalk to 7nm).
NRE_TOTAL = 35e6


@dataclass(frozen=True)
class TCOBreakdown:
    capex_rate: float  # $/s
    opex_rate: float  # $/s

    @property
    def rate(self) -> float:
        return self.capex_rate + self.opex_rate

    @property
    def capex_fraction(self) -> float:
        return self.capex_rate / max(self.rate, 1e-30)


def server_tco(server: ServerConfig) -> TCOBreakdown:
    capex = server.capex()
    life_s = SERVER_LIFE_YEARS * SECONDS_PER_YEAR
    dc_capex_rate = (DC_CAPEX_PER_W * server.tdp) / (
        DC_AMORT_YEARS * SECONDS_PER_YEAR)
    capex_rate = capex / life_s + dc_capex_rate

    avg_w = server.tdp * AVG_POWER_FRACTION * PUE
    energy_rate = avg_w / 1000.0 * ELECTRICITY_PER_KWH / 3600.0
    maint_rate = MAINTENANCE_FRACTION * capex / SECONDS_PER_YEAR
    return TCOBreakdown(capex_rate=capex_rate,
                        opex_rate=energy_rate + maint_rate)


def tco_per_mtoken(server: ServerConfig, servers: int,
                   tokens_per_s: float) -> float:
    """$ per 1M generated tokens for a deployment of `servers` servers."""
    rate = server_tco(server).rate * servers
    return rate / max(tokens_per_s, 1e-30) * 1e6


def nre_per_token(total_tokens: float) -> float:
    return NRE_TOTAL / max(total_tokens, 1.0)
