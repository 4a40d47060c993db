"""PLONK proof reader and verification-math assembly.

Loader-generic algorithmic parity with verifier/plonk/proof.rs and
protocol.rs:199-284 (CommonPolynomialEvaluation).  Only the halo2
linearization strategy (None — full quotient committed, no linearization
polynomial) is implemented; the enum exists for protocol compatibility.
"""

from __future__ import annotations

from dataclasses import dataclass

from benchmark.reference.errors import InvalidInstances, InvalidProtocol
from benchmark.reference.pcs import Query as PcsQuery
from benchmark.reference.util.fraction import Fraction, batch_invert_fractions
from benchmark.reference.util.msm_symbolic import Msm
from benchmark.reference.verifier.plonk.protocol import Query, Rotation


class CommonPolynomialEvaluation:
    """Batched evaluation of z^n, z^n - 1 and the needed Lagrange values with
    a single batch inversion (protocol.rs:199-284)."""

    def __init__(self, domain, lagranges, z):
        loader = z.loader
        self.zn = z.pow_const(domain.n)
        one = loader.load_one()
        self.zn_minus_one = self.zn - one
        self.zn_minus_one_inv = Fraction.one_over(self.zn_minus_one)
        self.identity = z

        lagranges = sorted(set(lagranges))
        n_inv = loader.load_const(domain.n_inv)
        numer = self.zn_minus_one * n_inv
        self.lagrange = {}
        for i in lagranges:
            omega_i = loader.load_const(domain.rotate_scalar(1, Rotation(i)))
            self.lagrange[i] = Fraction(numer * omega_i, z - omega_i)

        # one batched inversion for all denominators (plonk.rs:64-72)
        batch_invert_fractions(
            loader, list(self.lagrange.values()) + [self.zn_minus_one_inv]
        )
        for f in self.lagrange.values():
            f.evaluate()
        self.zn_minus_one_inv.evaluate()

    def get(self, key):
        kind, idx = key
        if kind == "identity":
            return self.identity
        return self.lagrange[idx].evaluated()


@dataclass
class PlonkProof:
    committed_instances: object  # list[EcPoint] | None
    witnesses: list
    challenges: list
    quotients: list
    z: object
    evaluations: list
    pcs: object
    old_accumulators: list

    # -- reading (proof.rs:52-169) ------------------------------------------
    @classmethod
    def read(cls, As, Ae, svk, protocol, instances, transcript):
        if protocol.transcript_initial_state is not None:
            transcript.common_scalar(protocol.transcript_initial_state)

        if protocol.num_instance != [len(ins) for ins in instances]:
            raise InvalidInstances(
                f"expected shape {protocol.num_instance}, got {[len(i) for i in instances]}"
            )

        committed_instances = None
        if protocol.instance_committing_key is not None:
            ick = protocol.instance_committing_key
            loader = transcript.loader()
            bases = [loader.ec_point_load_const(b) for b in ick.bases]
            constant = (
                loader.ec_point_load_const(ick.constant)
                if ick.constant is not None
                else None
            )
            committed_instances = []
            for ins in instances:
                msm = Msm.sum(
                    [Msm.base(b) * s for s, b in zip(ins, bases)]
                    + ([Msm.base(constant)] if constant is not None else [])
                )
                committed_instances.append(msm.evaluate(None))
            for ci in committed_instances:
                transcript.common_ec_point(ci)
        else:
            for ins in instances:
                for instance in ins:
                    transcript.common_scalar(instance)

        witnesses, challenges = [], []
        for n, m in zip(protocol.num_witness, protocol.num_challenge):
            witnesses.extend(transcript.read_n_ec_points(n))
            challenges.extend(transcript.squeeze_n_challenges(m))

        quotients = transcript.read_n_ec_points(protocol.quotient.num_chunk)
        z = transcript.squeeze_challenge()
        evaluations = transcript.read_n_scalars(len(protocol.evaluations))

        pcs = As.read_proof(svk, cls.empty_queries(protocol), transcript)

        old_accumulators = [
            Ae.from_repr([instances[i][j] for (i, j) in acc_indices])
            for acc_indices in protocol.accumulator_indices
        ]

        return cls(
            committed_instances,
            witnesses,
            challenges,
            quotients,
            z,
            evaluations,
            pcs,
            old_accumulators,
        )

    # -- assembly -----------------------------------------------------------
    @staticmethod
    def empty_queries(protocol):
        """(proof.rs:171-182)"""
        return [
            PcsQuery(q.poly, protocol.domain.rotate_scalar(1, q.rotation))
            for q in protocol.queries
        ]

    def queries(self, protocol, evaluations):
        """Attach evals to the protocol queries (proof.rs:184-199)."""
        out = []
        for q, empty in zip(protocol.queries, self.empty_queries(protocol)):
            out.append(empty.with_evaluation(evaluations.pop(q)))
        return out

    def commitments(self, protocol, common_poly_eval, evaluations):
        """Build the per-poly commitment MSM vector and the quotient
        evaluation (proof.rs:201-306), supporting all three linearization
        strategies (None / WithoutConstant / MinusVanishingTimesQuotient,
        proof.rs:272-303).

        The numerator evaluates over the Msm semiring: queried polys WITH a
        transcript evaluation contribute constants; linearized protocols
        leave some rotation-0 polys unevaluated, which contribute their
        commitment (so the result is an affine Msm, not a scalar)."""
        loader = common_poly_eval.identity.loader
        commitments = (
            [Msm.base(p) for p in protocol.preprocessed]
            + (
                [Msm.base(ci) for ci in self.committed_instances]
                if self.committed_instances is not None
                else [Msm() for _ in protocol.num_instance]
            )
            + [Msm.base(w) for w in self.witnesses]
        )

        def poly_cb(query):
            if query in evaluations:
                return Msm.constant_term(evaluations[query])
            if query.rotation.value == 0 and query.poly < len(commitments):
                return commitments[query.poly]
            raise InvalidProtocol(f"missing query {query}")

        def product(a, b):
            if a.size() == 0:
                return b * a.try_into_constant()
            if b.size() == 0:
                return a * b.try_into_constant()
            raise InvalidProtocol("invalid linearization (nonlinear product)")

        numerator = protocol.quotient.numerator.evaluate(
            constant=lambda v: Msm.constant_term(loader.load_const(v)),
            common_poly=lambda key: Msm.constant_term(common_poly_eval.get(key)),
            poly=poly_cb,
            challenge=lambda idx: Msm.constant_term(self.challenges[idx]),
            negated=lambda a: -a,
            sum_=lambda a, b: a + b,
            product=product,
            scaled=lambda a, v: a * loader.load_const(v),
        )

        quotient_query = Query.new(
            len(protocol.preprocessed) + len(protocol.num_instance) + len(self.witnesses)
        )
        chunk_coeffs = common_poly_eval.zn.pow_const(
            protocol.quotient.chunk_degree
        ).powers(len(self.quotients))
        quotient = Msm.sum(
            [
                Msm.base(chunk) * coeff
                for coeff, chunk in zip(chunk_coeffs, self.quotients)
            ]
        )

        if protocol.linearization == "without-constant":
            # older GWC19: prover sends the linearization poly's evaluation;
            # its commitment is reconstructed as the numerator's Msm part
            lin_query = Query.new(quotient_query.poly + 1)
            msm, constant = numerator.split()
            commitments.append(quotient)
            commitments.append(msm)
            evaluations[quotient_query] = (
                (constant if constant is not None else loader.load_zero())
                + self._poly_eval(evaluations, lin_query)
            ) * common_poly_eval.zn_minus_one_inv.evaluated()
        elif protocol.linearization == "minus-vanishing":
            # current GWC19: linearization poly evaluates to 0 by
            # subtracting vanishing * quotient
            msm, constant = (
                numerator - quotient * common_poly_eval.zn_minus_one
            ).split()
            commitments.append(msm)
            evaluations[quotient_query] = (
                constant if constant is not None else loader.load_zero()
            )
        elif protocol.linearization is None:
            commitments.append(quotient)
            numerator_const = numerator.try_into_constant()
            if numerator_const is None:
                raise InvalidProtocol("invalid linearization")
            evaluations[quotient_query] = (
                numerator_const * common_poly_eval.zn_minus_one_inv.evaluated()
            )
        else:
            raise InvalidProtocol(
                f"unknown linearization strategy {protocol.linearization!r}"
            )
        return commitments

    @staticmethod
    def _poly_eval(evaluations, query):
        if query not in evaluations:
            raise InvalidProtocol(f"missing query {query}")
        return evaluations[query]

    def evaluations_map(self, protocol, instances, common_poly_eval):
        """Evaluation dictionary incl. computed instance evals
        (proof.rs:308-349)."""
        loader = common_poly_eval.identity.loader
        evals = {}
        if protocol.instance_committing_key is None:
            offset = len(protocol.preprocessed)
            rng = range(offset, offset + len(protocol.num_instance))
            queries = [
                q for q in protocol.quotient.numerator.used_query() if q.poly in rng
            ]
            for query in queries:
                ins = instances[query.poly - offset]
                pairs = [
                    (
                        instance,
                        common_poly_eval.get(("lagrange", i - query.rotation.value)),
                    )
                    for i, instance in enumerate(ins)
                ]
                evals[query] = (
                    loader.sum_products(pairs) if pairs else loader.load_zero()
                )

        for query, eval_ in zip(protocol.evaluations, self.evaluations):
            evals[query] = eval_
        return evals
