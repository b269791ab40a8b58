"""Discrete-event constellation simulation: contact plans, multi-hop ISL
routing, in-orbit aggregation topologies, and an event-queue engine with
synchronous and asynchronous (FedBuff-style) operation."""
from .contacts import ContactPlan
from .engine import (Cohort, Delivery, Engine, RoundResult, Scenario,
                     group_cohorts)
from .routing import Route, Router, gateway_schedule
from .scenarios import SCENARIOS, get_scenario, names, register
from .topology import Topology, make_topology

__all__ = [
    "ContactPlan", "Cohort", "Delivery", "Engine", "RoundResult", "Scenario",
    "group_cohorts", "Route", "Router", "gateway_schedule",
    "SCENARIOS", "get_scenario", "names", "register",
    "Topology", "make_topology",
]
