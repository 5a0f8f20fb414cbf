"""The rule language. Unlike the reference package this does not import
the CNP YAML loader, so the port needs no ``yaml``."""

from cilium_tpu_torch.policy.api.selector import EndpointSelector, FQDNSelector
from cilium_tpu_torch.policy.api.l7 import (
    L7Rules,
    PortRuleHTTP,
    PortRuleKafka,
    PortRuleDNS,
    PortRuleL7,
    HeaderMatch,
    KAFKA_API_KEYS,
    KAFKA_ROLE_PRODUCE,
    KAFKA_ROLE_CONSUME,
)
from cilium_tpu_torch.policy.api.rule import (
    Rule,
    IngressRule,
    EgressRule,
    PortRule,
    PortProtocol,
    SanitizeError,
)

__all__ = [
    "EndpointSelector",
    "FQDNSelector",
    "L7Rules",
    "PortRuleHTTP",
    "PortRuleKafka",
    "PortRuleDNS",
    "PortRuleL7",
    "HeaderMatch",
    "KAFKA_API_KEYS",
    "KAFKA_ROLE_PRODUCE",
    "KAFKA_ROLE_CONSUME",
    "Rule",
    "IngressRule",
    "EgressRule",
    "PortRule",
    "PortProtocol",
    "SanitizeError",
]
