"""K8s control-plane analog (SURVEY §2.4 "K8s layer" row).

The reference's ``pkg/k8s/`` consumes CRDs — CiliumNetworkPolicy,
CiliumClusterwideNetworkPolicy, CiliumEndpoint, CiliumIdentity,
CiliumNode — from the kube-apiserver through list+watch reflectors and
feeds them into the policy repository; the agent publishes endpoint and
node status back. No kube-apiserver exists in this environment, so this
package provides the protocol-faithful core of that machinery:

* ``apiserver``  — a typed resource store served over a Unix socket
  with kube list/watch semantics: monotonic ``resourceVersion``,
  optimistic-concurrency updates (conflict on stale rv), bookmarked
  watch resume, and ``410 Gone`` + relist when a watcher is too far
  behind — the semantics client-go's Reflector is built against.
* ``informer``   — the Reflector/Informer analog: list, sync deltas,
  watch from the list's resourceVersion, relist on disconnect or Gone.
* agent wiring   — ``--k8s-api-socket`` makes the agent consume
  CNP/CCNP through informers (the "resource watchers feed policy repo"
  row) and publish CiliumEndpoint/CiliumNode objects back.
"""

from cilium_tpu_torch.k8s.apiserver import APIServer, K8sClient, WatchGone
from cilium_tpu_torch.k8s.informer import Informer

__all__ = ["APIServer", "K8sClient", "WatchGone", "Informer"]
