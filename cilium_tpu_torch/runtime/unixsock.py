"""Shared Unix-socket hygiene for the agent's servers."""

from __future__ import annotations

import os
import socket
import stat


def unlink_if_stale(path: str) -> None:
    """Remove ``path`` only if it is a dead leftover socket. A live
    server or a non-socket file raises — never silently hijack."""
    st = os.stat(path)
    if not stat.S_ISSOCK(st.st_mode):
        raise FileExistsError(
            f"{path} exists and is not a socket; refusing to unlink")
    probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        probe.settimeout(1.0)
        probe.connect(path)
    except (ConnectionRefusedError, FileNotFoundError):
        os.unlink(path)  # stale: nobody listening
    except OSError:
        os.unlink(path)  # unreachable/broken socket counts as stale
    else:
        raise FileExistsError(
            f"another server is live on {path}; refusing to replace")
    finally:
        probe.close()
