"""The port's rule-level policy trace against the JAX package's, on the
CPU: ``policy.trace.trace`` over the same repository and the same
hypothetical label sets gives the same answer (verdict, enforcement,
matched rules, notes).

Mirrors ``tests/test_policy_trace.py`` (its REST and CLI cases are in
``tests/test_torch_api.py``, over REST as the CLI calls it), and adds a
sweep: every CNP of ``examples/policies`` in one repository, traced for
each pair of a label-set grid at a set of ports and protocols, both
directions.
"""

import glob
import importlib
import os

from test_torch_agent import FIXTURES, both

CNP = """
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: api}
spec:
  endpointSelector: {matchLabels: {app: svc}}
  ingress:
  - fromEndpoints: [{matchLabels: {app: peer}}]
    toPorts:
    - ports: [{port: "80", protocol: TCP}]
      rules:
        http: [{method: GET}]
  - fromEndpoints: [{matchLabels: {app: peer}}]
    toPorts: [{ports: [{port: "8000", endPort: 8999, protocol: TCP}]}]
  ingressDeny:
  - fromEndpoints: [{matchLabels: {app: bad}}]
"""

RUNTIME = """
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: fqdn-named}
spec:
  endpointSelector: {matchLabels: {app: svc}}
  egress:
  - toFQDNs: [{matchName: example.com}]
    toPorts: [{ports: [{port: "https", protocol: TCP}]}]
  - toFQDNs: [{matchName: example.org}]
    toPorts: [{ports: [{port: "443", protocol: TCP}]}]
  - toServices: [{k8sService: {serviceName: db, namespace: default}}]
---
apiVersion: cilium.io/v2
kind: CiliumNetworkPolicy
metadata: {name: fqdn-icmp}
spec:
  endpointSelector: {matchLabels: {app: pinger}}
  egress:
  - toFQDNs: [{matchName: example.com}]
    icmps: [{fields: [{family: IPv4, type: 8}]}]
  - toEndpoints: [{matchLabels: {app: x}}]
    icmps: [{fields: [{family: IPv4, type: 0}]}]
"""


def repo_of(P, *texts):
    repo = importlib.import_module(
        f"{P.root}.policy.repository").Repository()
    for text in texts:
        for cnp in P.cnp.load_cnp_yaml_text(text):
            repo.add(list(cnp.rules))
    return repo


def ls(P, **kv):
    return P.labels.LabelSet.from_dict(kv)


def test_trace_allow_deny_default():
    def run(P, tmp):
        repo = repo_of(P, CNP)
        svc, peer, bad, other = (ls(P, app="svc"), ls(P, app="peer"),
                                 ls(P, app="bad"), ls(P, app="other"))
        t = P.trace.trace
        return [t(repo, src_labels=peer, dst_labels=svc, dport=80),
                t(repo, src_labels=peer, dst_labels=svc, dport=8500),
                t(repo, src_labels=peer, dst_labels=svc, dport=22),
                t(repo, src_labels=bad, dst_labels=svc, dport=80),
                t(repo, src_labels=peer, dst_labels=other, dport=80),
                t(repo, src_labels=peer, dst_labels=svc, dport=80,
                  proto=17),
                t(repo, src_labels=svc, dst_labels=peer, dport=80,
                  ingress=False)]

    got = both(run)
    assert [g["verdict"] for g in got[:5]] == [
        "ALLOWED", "ALLOWED", "DENIED", "DENIED", "ALLOWED"]
    assert got[0]["matched_rules"][0]["l7"] is True


def test_trace_runtime_peers_named_ports_and_icmps():
    def run(P, tmp):
        repo = repo_of(P, RUNTIME)
        t = P.trace.trace
        svc, x, pinger = ls(P, app="svc"), ls(P, app="x"), \
            ls(P, app="pinger")
        out = []
        for dport in (80, 443):
            out.append(t(repo, src_labels=svc, dst_labels=x, dport=dport,
                         ingress=False))
        out.append(t(repo, src_labels=svc, dst_labels=x, dport=443,
                     ingress=False, named_ports={"https": 443}))
        out.append(t(repo, src_labels=pinger, dst_labels=x, dport=80,
                     ingress=False))
        for dport in (8, 0, 3):
            out.append(t(repo, src_labels=pinger, dst_labels=x,
                         dport=dport, proto=1, ingress=False))
        return out

    got = both(run)
    assert any("toFQDNs" in n for n in got[1]["notes"])
    assert got[3]["notes"] == []


def _grid(P):
    L = P.labels.LabelSet
    sets = [L.from_dict(d) for d in (
        {"app": "service"}, {"app": "frontend"}, {"app": "svc"},
        {"app": "crawler"}, {"app": "kafka"}, {"app": "checkout"},
        {"app": "payments", "io.kubernetes.pod.namespace": "default"},
        {"app": "checkout", "io.kubernetes.pod.namespace": "default"},
        {"role": "backend", "env": "prod"}, {})]
    sets += [L.parse(["reserved:world"]), L.parse(["cidr:10.0.0.0/8"]),
             L.parse(["reserved:host"])]
    return sets


def test_trace_sweep_over_the_example_corpus():
    paths = sorted(glob.glob(os.path.join(FIXTURES, "**", "*.yaml"),
                             recursive=True))
    texts = [open(p).read() for p in paths]

    def run(P, tmp):
        ok = []
        for text in texts:
            try:
                P.cnp.load_cnp_yaml_text(text)
                ok.append(text)
            except Exception:  # noqa: BLE001 — a corpus file either
                continue       # package refuses is skipped by both
        repo = repo_of(P, *ok)
        grid = [P.endpoint.with_cluster_label(s, "default")
                for s in _grid(P)]
        out = [len(ok), len(repo.rules())]
        for i, src in enumerate(grid):
            for j, dst in enumerate(grid):
                for dport, proto in ((80, 6), (443, 6), (53, 17),
                                     (9092, 6), (8, 1)):
                    for ingress in (True, False):
                        r = P.trace.trace(repo, src, dst, dport=dport,
                                          proto=proto, ingress=ingress)
                        out.append([i, j, dport, proto, ingress, r])
        return out

    got = both(run)
    assert got[1] > 0
    verdicts = {r[5]["verdict"] for r in got[2:]}
    assert verdicts == {"ALLOWED", "DENIED"}
