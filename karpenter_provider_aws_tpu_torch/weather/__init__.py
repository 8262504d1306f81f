"""Adversarial scenario weather (docs/reference/weather.md): replayable
spot-market + interruption-storm chaos driving the degradation ladder.

The port of the JAX package's ``weather/``, module for module, with its
imports pointed into this package. The decisions draw on stdlib
``random`` exactly as there, so one scenario and seed give a
byte-identical timeline in both packages."""

from .fields import IceField, SpotMarketField
from .scenario import (IceSpell, NAMED_SCENARIOS, Regime, SidecarOutage,
                       Storm, WeatherScenario, load_scenario, named)
from .simulator import WeatherSimulator, inject_device_errors

__all__ = ["WeatherScenario", "Regime", "Storm", "IceSpell",
           "SidecarOutage", "NAMED_SCENARIOS", "named", "load_scenario",
           "SpotMarketField", "IceField",
           "WeatherSimulator", "inject_device_errors"]
