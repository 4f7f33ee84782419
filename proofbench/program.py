"""The system under test: ``zkstark_tpu_torch`` through its public entry
points, and nothing else of it.

A traffic mix names the entry (``mixes/<name>.json`` ``entry``): `prove`
(one proof a call, the fused default) or `prove_batch` (``batch`` proofs a
call). A call returns one (state, data) pair a secret, in the secrets' order.
"""

from __future__ import annotations

import torch


class Port:
    def __init__(self, st, mix: dict, device):
        from zkstark_tpu_torch import ops
        from zkstark_tpu_torch.field.fp import field_for
        from zkstark_tpu_torch.protocol import StarkConfig, prove
        from zkstark_tpu_torch.protocol.air import AIRS
        from zkstark_tpu_torch.protocol.batch import prove_batch

        self.cfg = StarkConfig(
            trace_len=st.trace_len, blowup=st.blowup, coset_offset=st.coset_offset,
            boundary_first=st.boundary_first, boundary_last=st.boundary_last,
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

    def call(self, secrets: list, timings: list | None = None) -> list:
        """The proofs of `secrets` as (state, data) pairs; on `prove`, each
        proof's spans are appended to `timings` where given (each span waits
        for the device)."""
        if self.entry == "prove":
            spans = {} if timings is not None else None
            proof = self._prove(self.cfg, secrets[0], device=self.device, timings=spans)
            if timings is not None:
                timings.append(spans)
            proofs = [proof]
        else:
            proofs = self._batch(self.cfg, secrets, device=self.device)
        return [(pf.state, pf.data) for pf in proofs]

    def launch_counts(self) -> dict:
        """The program's kernel launches so far, by kernel."""
        return dict(self._counts())
