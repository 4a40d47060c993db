"""PlonkProtocol (de)serialization.

The compatibility hinge with the reference (SURVEY §7 step 5): the
reference's `PlonkProtocol` derives serde (protocol.rs:19), so protocols
compiled from real halo2 verifying keys with its `compile()` can be dumped
to JSON and imported here, skipping any halo2 dependency.  The layout below
mirrors serde's default encoding of the Rust types:

* field elements: 32-entry little-endian byte arrays (halo2curves serde);
  hex strings ("0x...") are also accepted;
* G1 points: {"x": <fe>, "y": <fe>};
* enums: externally tagged ({"Polynomial": {...}}, {"Sum": [a, b]}, ...);
* Rotation: plain int; Query: {"poly": n, "rotation": n}.
"""

from __future__ import annotations

import json

from benchmark.reference.verifier.plonk.protocol import (
    Challenge,
    CommonIdentity,
    CommonLagrange,
    Constant,
    DistributePowers,
    Domain,
    InstanceCommittingKey,
    Negated,
    PlonkProtocol,
    Polynomial,
    Product,
    Query,
    QuotientPolynomial,
    Rotation,
    Scaled,
    Sum,
)


def _fe_to_json(v: int):
    return list(int(v).to_bytes(32, "little"))


def _fe_from_json(obj) -> int:
    if isinstance(obj, str):
        return int(obj, 16)
    if isinstance(obj, int):
        return obj
    return int.from_bytes(bytes(obj), "little")


def _pt_to_json(pt):
    if pt is None:
        return {"x": _fe_to_json(0), "y": _fe_to_json(0)}
    return {"x": _fe_to_json(pt[0]), "y": _fe_to_json(pt[1])}


def _pt_from_json(obj):
    if isinstance(obj, (list, tuple)):
        x, y = obj
    else:
        x, y = obj["x"], obj["y"]
    x, y = _fe_from_json(x), _fe_from_json(y)
    return None if (x, y) == (0, 0) else (x, y)


def _rotation_from_json(obj) -> Rotation:
    return Rotation(obj if isinstance(obj, int) else obj["0"])


def _query_to_json(q: Query):
    return {"poly": q.poly, "rotation": q.rotation.value}


def _query_from_json(obj) -> Query:
    return Query(obj["poly"], _rotation_from_json(obj["rotation"]))


def _expr_to_json(e):
    if isinstance(e, Constant):
        return {"Constant": _fe_to_json(e.value)}
    if isinstance(e, CommonIdentity):
        return {"CommonPolynomial": "Identity"}
    if isinstance(e, CommonLagrange):
        return {"CommonPolynomial": {"Lagrange": e.index}}
    if isinstance(e, Polynomial):
        return {"Polynomial": _query_to_json(e.query)}
    if isinstance(e, Challenge):
        return {"Challenge": e.index}
    if isinstance(e, Negated):
        return {"Negated": _expr_to_json(e.inner)}
    if isinstance(e, Sum):
        return {"Sum": [_expr_to_json(e.lhs), _expr_to_json(e.rhs)]}
    if isinstance(e, Product):
        return {"Product": [_expr_to_json(e.lhs), _expr_to_json(e.rhs)]}
    if isinstance(e, Scaled):
        return {"Scaled": [_expr_to_json(e.inner), _fe_to_json(e.scalar)]}
    if isinstance(e, DistributePowers):
        return {
            "DistributePowers": [
                [_expr_to_json(x) for x in e.exprs],
                _expr_to_json(e.base),
            ]
        }
    raise TypeError(f"unknown expression node {type(e)}")


def _expr_from_json(obj):
    assert len(obj) == 1
    tag, val = next(iter(obj.items()))
    if tag == "Constant":
        return Constant(_fe_from_json(val))
    if tag == "CommonPolynomial":
        if val == "Identity":
            return CommonIdentity()
        if isinstance(val, dict) and "Lagrange" in val:
            return CommonLagrange(val["Lagrange"])
        raise ValueError(f"unknown common polynomial {val}")
    if tag == "Polynomial":
        return Polynomial(_query_from_json(val))
    if tag == "Challenge":
        return Challenge(val)
    if tag == "Negated":
        return Negated(_expr_from_json(val))
    if tag == "Sum":
        return Sum(_expr_from_json(val[0]), _expr_from_json(val[1]))
    if tag == "Product":
        return Product(_expr_from_json(val[0]), _expr_from_json(val[1]))
    if tag == "Scaled":
        return Scaled(_expr_from_json(val[0]), _fe_from_json(val[1]))
    if tag == "DistributePowers":
        return DistributePowers(
            tuple(_expr_from_json(x) for x in val[0]), _expr_from_json(val[1])
        )
    raise ValueError(f"unknown expression tag {tag}")


# serde unit-variant names (protocol.rs:531-540) <-> internal tags
_LINEARIZATION_FROM_SERDE = {
    "WithoutConstant": "without-constant",
    "MinusVanishingTimesQuotient": "minus-vanishing",
    None: None,
}
_LINEARIZATION_TO_SERDE = {v: k for k, v in _LINEARIZATION_FROM_SERDE.items()}


def protocol_to_json(p: PlonkProtocol) -> dict:
    return {
        "domain": {
            "k": p.domain.k,
            "n": p.domain.n,
            "n_inv": _fe_to_json(p.domain.n_inv),
            "gen": _fe_to_json(p.domain.gen),
            "gen_inv": _fe_to_json(p.domain.gen_inv),
        },
        "preprocessed": [_pt_to_json(pt) for pt in p.preprocessed],
        "num_instance": list(p.num_instance),
        "num_witness": list(p.num_witness),
        "num_challenge": list(p.num_challenge),
        "evaluations": [_query_to_json(q) for q in p.evaluations],
        "queries": [_query_to_json(q) for q in p.queries],
        "quotient": {
            "chunk_degree": p.quotient.chunk_degree,
            "num_chunk": p.quotient.num_chunk,
            "numerator": _expr_to_json(p.quotient.numerator),
        },
        "transcript_initial_state": (
            _fe_to_json(p.transcript_initial_state)
            if p.transcript_initial_state is not None
            else None
        ),
        "instance_committing_key": (
            {
                "bases": [_pt_to_json(b) for b in p.instance_committing_key.bases],
                "constant": (
                    _pt_to_json(p.instance_committing_key.constant)
                    if p.instance_committing_key.constant is not None
                    else None
                ),
            }
            if p.instance_committing_key is not None
            else None
        ),
        "linearization": _LINEARIZATION_TO_SERDE.get(p.linearization, p.linearization),
        "accumulator_indices": [
            [[i, j] for (i, j) in acc] for acc in p.accumulator_indices
        ],
    }


def protocol_from_json(obj) -> PlonkProtocol:
    if isinstance(obj, str):
        obj = json.loads(obj)
    d = obj["domain"]
    domain = Domain(
        k=d["k"],
        n=d["n"],
        n_inv=_fe_from_json(d["n_inv"]),
        gen=_fe_from_json(d["gen"]),
        gen_inv=_fe_from_json(d["gen_inv"]),
    )
    ick = obj.get("instance_committing_key")
    return PlonkProtocol(
        domain=domain,
        preprocessed=[_pt_from_json(pt) for pt in obj["preprocessed"]],
        num_instance=list(obj["num_instance"]),
        num_witness=list(obj["num_witness"]),
        num_challenge=list(obj["num_challenge"]),
        evaluations=[_query_from_json(q) for q in obj["evaluations"]],
        queries=[_query_from_json(q) for q in obj["queries"]],
        quotient=QuotientPolynomial(
            obj["quotient"]["chunk_degree"],
            obj["quotient"]["num_chunk"],
            _expr_from_json(obj["quotient"]["numerator"]),
        ),
        transcript_initial_state=(
            _fe_from_json(obj["transcript_initial_state"])
            if obj.get("transcript_initial_state") is not None
            else None
        ),
        instance_committing_key=(
            InstanceCommittingKey(
                bases=[_pt_from_json(b) for b in ick["bases"]],
                constant=(
                    _pt_from_json(ick["constant"])
                    if ick.get("constant") is not None
                    else None
                ),
            )
            if ick is not None
            else None
        ),
        linearization=_LINEARIZATION_FROM_SERDE.get(
            obj.get("linearization"), obj.get("linearization")
        ),
        accumulator_indices=[
            [tuple(pair) for pair in acc] for acc in obj.get("accumulator_indices", [])
        ],
    )
