"""Matmul numerics policy, and the audit that checks it.

Every matrix product on the main path names its numerics:

- **float32 operands run at** ``jax.lax.Precision.HIGHEST``, stated at the
  call site.  At default precision XLA:GPU may run f32 products in TF32
  (10-bit significand) on the tensor cores, which would make the one-hot
  selections inexact (ORB column select, BA pose assembly) and cost digits
  in the LM / Schur normal equations, Horn/Kabsch cross-covariances and
  the pose graph.  The BA normal equations must stay f32: built from bf16
  blocks they lose positive definiteness (``pipeline/backend.py``).
- **bfloat16 by design**, with f32 accumulation: the BRIEF diff-table
  matmul (``VOConfig.orb_bf16``) and the ORB patch canvas under
  ``orb_patch_bf16``.  Their one-hot operands are exact in bf16.  XLA:CPU's
  dot thunk refuses
  the BRIEF matmul's bf16 x bf16 -> f32, so ORB keeps f32 on the CPU
  backend (``ops/orb.py``).
- **int8 operands with int32 accumulation**, exact by construction: Hamming
  distances (``ops/matching.py``), covisibility ``A @ A^T``
  (``mapstate.py``) and the bit-plane ``inverse_lookup``
  (``ops/packing.py``).

:func:`dot_census` traces a function and counts its ``dot_general``
operations by operand dtype and precision, so a test (and the GPU smoke
run) can assert that no float32 product is left at default precision.
"""

from __future__ import annotations

import collections

import jax
import numpy as np


def _sub_jaxprs(value):
    if hasattr(value, "eqns"):
        yield value
    elif hasattr(value, "jaxpr") and hasattr(value.jaxpr, "eqns"):
        yield value.jaxpr
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _walk(jaxpr, counts):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            dtype = np.dtype(eqn.invars[0].aval.dtype).name
            prec = eqn.params.get("precision")
            if isinstance(prec, tuple):
                prec = "/".join(sorted({str(p) for p in prec}))
            counts[(dtype, str(prec))] += 1
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                _walk(sub, counts)


def dot_census(fn, *args) -> collections.Counter:
    """Count ``dot_general`` ops in ``fn(*args)`` by ``(operand dtype,
    precision)``; sub-programs (loops, conds, nested jits) included."""
    counts: collections.Counter = collections.Counter()
    _walk(jax.make_jaxpr(fn)(*args).jaxpr, counts)
    return counts


def implicit_float_dots(census: collections.Counter) -> dict:
    """The census entries that break the policy: float32/float64 products
    whose precision is not HIGHEST."""
    return {
        k: n
        for k, n in census.items()
        if k[0] in ("float32", "float64") and k[1] != "HIGHEST"
    }
