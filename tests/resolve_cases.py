"""Random group-space resolve plans and batches, shared by the plain
resolve's CPU tests (against the JAX package) and KR's card tests
(against the plain resolve). Numpy only: the card's machine has no JAX.

A case is every table ``resolve_cuda.resolve_groups_plain`` reads, at G
groups in each of the HTTP, kafka, generic and frontend families (and
``ceil(G / 32)`` DNS lane words), drawn to hit the plain code's edges:
lanes of -1 and past the last word, words with bit 31 set, rule-set
masks with bits past G, rule sets of -1 and past the last, the dummy
"never a member" groups (proto or family -1), Hm header and Lm LOG lanes
a group. The per-row lanes are columns of one int32 block, and the pair
ids a slice of it, as the capture step's row block gives them.
"""

import numpy as np

#: per-row block: l7 type, four kafka columns, gen proto, then F pair ids
BLOCK_COLS, F = 6, 4


def _u32(rng, shape, density):
    """uint32 words whose bits are set with probability ``density`` (1/8,
    1/4, 1/2 or 3/4: ANDs and ORs of uniform words), one with bit 31
    alone."""
    def draw():
        return rng.integers(0, 2 ** 32, shape, dtype=np.uint64) \
            .astype(np.uint32)

    words = {0.125: lambda: draw() & draw() & draw(),
             0.25: lambda: draw() & draw(), 0.5: draw,
             0.75: lambda: draw() | draw()}[density]()
    if words.size:
        words.reshape(-1)[0] = np.uint32(1 << 31)
    return words


def _lanes(rng, shape, nw, minus=0.3):
    """Lane ids in [0, 32 * nw + 40): some past the last word, and -1
    with probability ``minus``."""
    lanes = rng.integers(0, 32 * nw + 40, shape).astype(np.int32)
    lanes[rng.random(shape) < minus] = -1
    return lanes


def random_case(seed, G, B, *, gen=True, fe=True, RS=5, NW=3, Hm=3, Lm=2):
    """→ (arrays, inputs): the plan's tables ({name: numpy}, uint32
    bitmaps) and the batch (``ruleset``, the int32 ``block``, ``words``
    (path, method, host, headers, qname[, l7g]) as uint32 [B, NW],
    ``gwords``), with the generic block (and the frontend tables and
    l7g words) only under ``gen`` (and ``fe``)."""
    rng = np.random.default_rng(seed)
    Gw = (G + 31) // 32
    arrays = {
        "rs_http_mask": np.zeros((RS, 1), np.uint32),
        "rp_g_method": _lanes(rng, (G,), NW),
        "rp_g_host": _lanes(rng, (G,), NW),
        "rp_g_hdr": _lanes(rng, (G, Hm), NW),
        "rp_g_log": _lanes(rng, (G, Lm), NW, minus=0.5),
        "rp_g_anypath": rng.random(G) < 0.3,
        "rp_g_haslog": rng.random(G) < 0.4,
        "rp_rs_gmask": _u32(rng, (RS, Gw), 0.5),
        "rp_dns_rsmask": _u32(rng, (RS, Gw), 0.125),
        "rp_k_apikey_mask": _u32(rng, (G,), 0.25),
        "rp_k_version": rng.integers(-1, 3, G).astype(np.int32),
        "rp_k_client": rng.integers(-1, 3, G).astype(np.int32),
        "rp_k_topic": rng.integers(-1, 3, G).astype(np.int32),
        "rp_rs_kmask": _u32(rng, (RS, Gw), 0.5),
        "rp_gen_proto": rng.integers(-1, 3, G).astype(np.int32),
        "rp_gen_pairs": rng.integers(-1, 6, (G, 3)).astype(np.int32),
        "rp_rs_genmask": _u32(rng, (RS, Gw), 0.5),
    }
    arrays["rp_k_apikey_mask"][::4] = 0          # api key unconstrained
    if fe:
        arrays.update({
            "fe_lane": np.zeros(1, np.int32),    # the frontend plane's mark
            "rp_fe_family": rng.integers(-1, 8, G).astype(np.int32),
            "rp_fe_lane": _lanes(rng, (G,), NW),
            "rp_fe_pairs": rng.integers(-1, 6, (G, 2)).astype(np.int32),
            "rp_rs_femask": _u32(rng, (RS, Gw), 0.5),
        })
    ruleset = rng.integers(-2, RS + 2, B).astype(np.int32)
    block = np.empty((B, BLOCK_COLS + F), np.int32)
    block[:, 0] = rng.integers(0, 8, B)                  # l7 type
    block[:, 1] = rng.integers(-1, 33, B)                # api key
    block[:, 1][:4] = 31                                 # bit-31 api key
    block[:, 2:4] = rng.integers(0, 3, (B, 2))           # version, client
    block[:, 4] = rng.integers(-2, 3, B)                 # topic
    block[:, 5] = rng.integers(-2, 3, B)                 # gen proto
    block[:, BLOCK_COLS:] = rng.integers(-2, 6, (B, F))  # pair ids
    words = [_u32(rng, (B, 1), 0.5)] + [_u32(rng, (B, NW), 0.75)
                                         for _ in range(3)]
    words.append(_u32(rng, (B, Gw), 0.125))                # qname
    if gen and fe:
        words.append(_u32(rng, (B, NW), 0.75))            # l7g
    inputs = {"ruleset": ruleset, "block": block, "words": words,
              "gwords": _u32(rng, (B, Gw), 0.5), "gen": gen}
    return arrays, inputs


def torch_args(arrays, inputs, device):
    """The case as ``resolve_groups_*``'s arguments on ``device``: the
    tables as the engine stages them (uint32 as int32), the per-row
    lanes as column views of the staged block."""
    from cilium_tpu_torch.weights import stage_array

    t = {k: stage_array(v, device) for k, v in arrays.items()}
    block = stage_array(inputs["block"], device)
    kafka = tuple(block[:, c] for c in range(1, 5))
    gen = (block[:, 5], block[:, BLOCK_COLS:]) if inputs["gen"] else None
    words = tuple(stage_array(w, device) for w in inputs["words"])
    return (t, stage_array(inputs["ruleset"], device), block[:, 0], words,
            stage_array(inputs["gwords"], device), kafka, gen)


#: G groups a family x B rows: the card's cases (the CPU's use small B)
GROUPS = (1, 15, 63, 2047)
ROWS = (1, 257, 262144)
