"""proxylib-style L7 parser plugin framework (the reference's
``cilium_tpu/proxylib``): ``OnNewConnection`` builds a parser by the
policy's ``l7proto`` name, ``OnData`` returns PASS/DROP/MORE/INJECT/
ERROR ops, and every parsed record is verdicted through the
``policy_check`` the verdict service injects.

Registered: HTTP, Kafka, r2d2, memcache, cassandra and the test
parsers (``test.passer``, ``test.lineparser``, ``test.blockparser``).
The last four kinds yield ``GenericL7Info`` records: a frontend
protocol's verdict on the ``l7g`` field, a proxy-only one's on the
generic pair path. Every ``register_parser`` name joins the compiler's
``l7proto`` registry (``policy/compiler/frontends``).
"""

from cilium_tpu_torch.proxylib.parser import (
    Connection,
    OpType,
    Parser,
    Verdict as ParserVerdict,
    create_parser,
    register_parser,
    registered_parsers,
)
from cilium_tpu_torch.proxylib.http import HTTPParser
from cilium_tpu_torch.proxylib.kafka import KafkaParser
from cilium_tpu_torch.proxylib.r2d2 import R2D2Parser
from cilium_tpu_torch.proxylib.memcached import MemcachedParser
from cilium_tpu_torch.proxylib.cassandra import CassandraParser
from cilium_tpu_torch.proxylib import testparsers  # noqa: F401  (registers)

__all__ = [
    "OpType",
    "ParserVerdict",
    "Connection",
    "Parser",
    "register_parser",
    "create_parser",
    "registered_parsers",
    "KafkaParser",
    "HTTPParser",
    "R2D2Parser",
    "MemcachedParser",
    "CassandraParser",
]
