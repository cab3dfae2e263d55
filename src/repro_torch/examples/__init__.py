"""The reference's five examples on the port, each run as
``python -m repro_torch.examples.<name>`` (on the card unless
``--device cpu``) or called as ``main(argv)``:

* ``quickstart``        — the ``quickstart`` preset through
                          ``experiments.run``, one line a round;
* ``cefl_vs_baselines`` — the constants estimation, then ``cefl`` against
                          ``fednova`` and ``fedavg`` (Tables I-II style);
* ``mobility_demo``     — ``campus_walk`` under ``cefl`` and ``fixed:0``:
                          aggregator migrations and handovers;
* ``serve_lm``          — prefill and a batched greedy decode of any
                          architecture;
* ``train_lm_cefl``     — CE-FL LM training (``lm_smoke``, or
                          ``lm_mamba2_130m`` with ``--full``).
"""
