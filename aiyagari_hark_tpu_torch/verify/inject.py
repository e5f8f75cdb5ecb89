"""Deterministic corruption injection (port of
``aiyagari_hark_tpu/verify/inject.py``): every silent-corruption
detection path of the integrity layer can be driven on the CPU.  Nothing
in a solve calls these; each corrupts exactly one artifact.

* ``flip_row_bit`` / ``perturb_row``: in-memory packed-row corruption (the
  SDC drills of the sweep's recheck, ``run_sweep(inject_sdc=)``);
* ``corrupt_ledger_row``: one solved row's bytes rewritten inside a saved
  resume ledger, its solve-time checksum kept; the resume must recompute
  the cell;
* ``perturbed_policy``: an off-by-one grid shift or small noise on a
  consumption policy, finite and plausible, which only a posteriori
  certification catches.

``corrupt_store_entry`` belongs to the solution store of the serve tier
(ROADMAP Queue 1 item 8b).
"""

from __future__ import annotations

import numpy as np
import torch


def flip_row_bit(row, field: int = 0, bit: int = 20) -> np.ndarray:
    """A copy of one packed row with bit ``bit`` of ``row[field]`` flipped
    (as float64 bits): a single-event upset."""
    row = np.array(row, dtype=np.float64)
    bits = row.view(np.uint64)
    bits[field] ^= np.uint64(1) << np.uint64(bit)
    return row


def perturb_row(row, field: int = 0, amplitude: float = 1e-6) -> np.ndarray:
    """A copy of one packed row with ``amplitude`` added to ``row[field]``:
    finite, plausible and wrong."""
    row = np.array(row, dtype=np.float64)
    row[field] += amplitude
    return row


def _rewrite_npz_leaf(path: str, leaf_index: int, mutate) -> None:
    """Rewrite one ``save_pytree`` leaf in place, every other leaf and the
    structure string kept byte for byte: the file still parses and still
    claims its solve-time checksums."""
    with np.load(path) as data:   # integrity-ok: the corruption injector
        arrays = {k: np.array(data[k]) for k in data.files}
    key = f"leaf_{leaf_index:06d}"
    if key not in arrays:
        raise KeyError(f"{path} has no leaf {leaf_index}")
    arrays[key] = mutate(arrays[key])
    with open(path, "wb") as f:   # atomic-ok: deliberate corruption injector
        np.savez(f, **arrays)


def corrupt_ledger_row(path: str, cell: int, field: int = 0,
                       bit: int = 20) -> None:
    """Flip one bit of solved cell ``cell``'s packed row inside a saved
    sweep resume ledger, its recorded checksum untouched.
    ``LedgerState.resume`` must detect the mismatch and recompute the
    cell, never reassemble the corrupt bits."""
    from ..utils.resilience import SweepLedger

    def mutate(packed):
        packed = np.array(packed)
        packed[cell] = flip_row_bit(packed[cell], field=field, bit=bit)
        return packed

    _rewrite_npz_leaf(path, SweepLedger._fields.index("packed"), mutate)


def perturbed_policy(policy, mode: str = "noise", amplitude: float = 1e-6,
                     seed: int = 0):
    """A deliberately wrong consumption policy that every structural check
    passes:

    * ``mode="shift"``: off-by-one grid shift, each knot taking its right
      neighbour's consumption (still monotone and positive);
    * ``mode="noise"``: ``amplitude`` noise from
      ``np.random.default_rng(seed)`` on the consumption knots (the JAX
      package's draws, so both packages perturb alike).
    """
    c = policy.c_knots.detach().cpu().numpy().astype(np.float64)
    if mode == "shift":
        shifted = np.concatenate([c[:, :1], c[:, 2:], c[:, -1:]], axis=1)
    elif mode == "noise":
        rng = np.random.default_rng(seed)
        shifted = c + amplitude * rng.standard_normal(c.shape)
    else:
        raise ValueError(f"perturbed_policy mode must be 'shift' or "
                         f"'noise', got {mode!r}")
    return policy._replace(c_knots=torch.as_tensor(
        shifted, dtype=policy.c_knots.dtype, device=policy.c_knots.device))
