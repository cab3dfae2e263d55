"""Counterpart of ``repro.network``: the three-tier topology and the
delay / energy cost model."""
from repro_torch.network.costs import (  # noqa: F401
    data_configuration, network_costs, round_delay, round_energy,
)
from repro_torch.network.topology import (  # noqa: F401
    Network, NetworkConfig, make_network, pathloss_gain, shannon_rate,
)
