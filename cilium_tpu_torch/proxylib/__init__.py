"""proxylib-style L7 parser plugin framework (the reference's
``cilium_tpu/proxylib``): ``OnNewConnection`` builds a parser by the
policy's ``l7proto`` name, ``OnData`` returns PASS/DROP/MORE/INJECT/
ERROR ops, and every parsed record is verdicted through the
``policy_check`` the verdict service injects.

The HTTP and Kafka parsers are registered. The reference's r2d2,
memcache and cassandra parsers and its test parsers yield
``GenericL7Info`` records, which need the ``l7g`` field (queue 1, Q5):
``create_parser`` raises ``NotImplementedError`` naming Q5 for them.
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
]
