"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a card is skipped and the rest of a run (set-up,
window, check) drives the port on the CPU at small sizes, with each
fault a cell can have planted in the port's entry point.  One cell holds
a single chip, so no exchange between chips can be left out."""

import pytest
import torch

from phsfl_bench.tests import small


def _round_fault(monkeypatch, fault):
    import repro_torch.core.phsfl as phsfl
    real = phsfl.make_host_round

    def broken(*a, **k):
        r = real(*a, **k)
        fn = r.fn

        def run(params, state, batch, au, ab):
            if fault == "half":
                rows = batch["tokens"].shape[2] // 2
                batch = {n: v[:, :, :rows] for n, v in batch.items()}
            p, s, m = fn(params, state, batch, au, ab)
            if fault == "unchanged":
                return params, s, m
            if fault == "altered":          # one leaf's result moved double
                w, w0 = p["embed"]["table"], params["embed"]["table"]
                w.copy_(2 * w - w0)
            return p, s, m

        r.fn = run
        return r

    monkeypatch.setattr(phsfl, "make_host_round", broken)


def _bank_fault(monkeypatch, fault):
    import repro_torch.core.personalize as pers
    real = pers.personalize_head_bank

    def broken(model, params, batches, tcfg):
        if fault == "half":
            rows = batches["tokens"].shape[1] // 2
            batches = {n: v[:, :rows] for n, v in batches.items()}
        bank, losses = real(model, params, batches, tcfg)
        w0 = params["lm_head"]["w"]
        if fault == "unchanged":
            bank = w0.expand_as(bank).clone()
        if fault == "altered":              # one client's head moved double
            bank[0] = 2 * bank[0] - w0
        return bank, losses

    monkeypatch.setattr(pers, "personalize_head_bank", broken)


@pytest.mark.parametrize("family", ["olmoe", "seamless"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_round_fault_is_not_correct(monkeypatch, family, fault):
    torch.manual_seed(0)
    _round_fault(monkeypatch, fault)
    traffic = small.ROUND if family == "olmoe" else small.ENCDEC_ROUND
    res = small.run(family, traffic)
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_bank_fault_is_not_correct(monkeypatch, fault):
    _bank_fault(monkeypatch, fault)
    res = small.run("olmoe", small.BANK)
    assert not res["correct"], (fault, res["checks"])
