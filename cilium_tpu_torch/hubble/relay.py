"""Hubble Relay's peer discovery: the kvstore directory of per-node
observer sockets (the Hubble Peer service analog).

The port carries :class:`PeerDirectory` (with its ``PREFIX``), which
the agent's Hubble socket advertises under. The relay itself — the
scatter-gather over peers, the merge-sort by time, the live and
snapshot modes and its command line — is queue 1's Q13b part 2; until
then a directory is started against any object with the relay's
``add_remote_peer(name, socket)`` / ``remove_peer(name)`` faces.
"""

from __future__ import annotations

import json


class PeerDirectory:
    """kvstore-backed peer discovery (the Hubble Peer service analog):
    agents publish ``cilium/hubble/peers/<node> → {"socket": path}``
    under their registration lease; the relay watches the prefix and
    keeps the peer set current as nodes come and go."""

    PREFIX = "cilium/hubble/peers/"

    def __init__(self, store, relay):
        self.store = store
        self.relay = relay
        self._watch = None

    def start(self) -> "PeerDirectory":
        from cilium_tpu_torch.kvstore import EVENT_DELETE

        def on_event(ev):
            name = ev.key[len(self.PREFIX):]
            if ev.typ == EVENT_DELETE:
                self.relay.remove_peer(name)
                return
            try:
                sock = json.loads(ev.value)["socket"]
            except (ValueError, KeyError, TypeError):
                return
            self.relay.add_remote_peer(name, sock)

        self._watch = self.store.watch_prefix(self.PREFIX, on_event)
        return self

    def stop(self) -> None:
        if self._watch is not None:
            self._watch.stop()
            self._watch = None
