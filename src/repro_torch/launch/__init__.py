"""Launchers (counterpart of ``repro.launch``): ``train``, the CE-FL LM
training shim over ``repro_torch.experiments.lm.run_lm``."""
