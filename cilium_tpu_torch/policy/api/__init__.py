"""The rule language and the CiliumNetworkPolicy loader. The loader
reads YAML with the port's own reader of the subset CNP files use
(``_yaml.py``), so the port needs no ``yaml``."""

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
from cilium_tpu_torch.policy.api.cnp import (
    CiliumNetworkPolicy,
    load_cnp_yaml,
    load_cnp_dir,
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
    "CiliumNetworkPolicy",
    "load_cnp_yaml",
    "load_cnp_dir",
]
