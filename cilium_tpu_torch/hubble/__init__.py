"""Hubble-style observability: flow ring, observer, metrics, exporter
and the observer's socket server — the counterpart of the reference's
``hubble`` package.

Reference: ``pkg/hubble`` (SURVEY.md §2.5) — monitor/accesslog events
become ``flowpb.Flow``s in a fixed-size ring served over
``Observer.GetFlows`` (with follow + filters), with flow-metrics
handlers and a JSONL exporter. Verdicted flows come straight from the
engine's outputs (one readback a batch). ``hubble/relay.py`` carries
the cluster-wide relay (snapshot and live) and ``PeerDirectory``, under
which the agent advertises its Hubble socket; a ``HubbleServer`` given
a ``relay`` answers ``peers`` from it, and without one ``{"error": "not
a relay"}``.
"""

from cilium_tpu_torch.hubble.ring import FlowRing
from cilium_tpu_torch.hubble.observer import (
    FlowFilter,
    Observer,
    annotate_flows,
)
from cilium_tpu_torch.hubble.metrics import FlowMetrics
from cilium_tpu_torch.hubble.exporter import FlowExporter
from cilium_tpu_torch.hubble.relay import Peer, Relay
from cilium_tpu_torch.hubble.server import HubbleClient, HubbleServer

__all__ = [
    "FlowRing",
    "Observer",
    "FlowFilter",
    "annotate_flows",
    "FlowMetrics",
    "FlowExporter",
    "Peer",
    "Relay",
    "HubbleClient",
    "HubbleServer",
]
