"""The system under test: ``zkstark_tpu_torch`` through its public entry
points, and nothing else of it.

A traffic mix names the entry (``mixes/<name>.json`` ``entry``): `prove`
(one proof a call, the fused default) or `prove_batch` (``batch`` proofs a
call). A call takes witnesses (``statement.Witness``: a secret and its
public values) and returns one (state, data) pair a witness, in their order.
The port's config of each distinct set of public values is built once, when
the port is, and reused: a run of one public output has one config object.
"""

from __future__ import annotations

import torch

from proofbench.yardstick.statement import publics_key


class Port:
    def __init__(self, st, mix: dict, device):
        from zkstark_tpu_torch import ops
        from zkstark_tpu_torch.field.fp import field_for
        from zkstark_tpu_torch.protocol import StarkConfig, prove
        from zkstark_tpu_torch.protocol.air import AIRS
        from zkstark_tpu_torch.protocol.batch import prove_batch

        self.cfgs = {}
        for w in st.cycle:
            key, pub = publics_key(w.publics), w.publics
            if key not in self.cfgs:
                self.cfgs[key] = StarkConfig(
                    trace_len=st.trace_len, blowup=st.blowup, coset_offset=st.coset_offset,
                    boundary_first=pub["boundary_first"], boundary_last=pub["boundary_last"],
                    n_queries=st.n_queries, air=AIRS[st.air], field=field_for(st.p),
                )
        self.device = torch.device(device)
        self.entry = mix["entry"]
        self._prove, self._batch = prove, prove_batch
        self._counts = ops.launch_counts
        if self.entry not in ("prove", "prove_batch"):
            raise ValueError(f"no entry {self.entry!r}")
        if self.entry == "prove" and int(mix["batch"]) != 1:
            raise ValueError("the entry `prove` takes one secret a call")

    def call(self, witnesses: list, timings: list | None = None) -> list:
        """The proofs of `witnesses` as (state, data) pairs; on `prove`, each
        proof's spans are appended to `timings` where given (each span waits
        for the device). A batch is one statement: witnesses that differ in
        their public values raise ValueError."""
        keys = {publics_key(w.publics) for w in witnesses}
        if len(keys) != 1:
            raise ValueError(f"a batch is one statement: its {len(witnesses)} witnesses "
                             f"state {len(keys)} sets of public values")
        cfg = self.cfgs[keys.pop()]
        secrets = [int(w) for w in witnesses]
        if self.entry == "prove":
            spans = {} if timings is not None else None
            proof = self._prove(cfg, secrets[0], device=self.device, timings=spans)
            if timings is not None:
                timings.append(spans)
            proofs = [proof]
        else:
            proofs = self._batch(cfg, secrets, device=self.device)
        return [(pf.state, pf.data) for pf in proofs]

    def launch_counts(self) -> dict:
        """The program's kernel launches so far, by kernel."""
        return dict(self._counts())
