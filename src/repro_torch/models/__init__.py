"""The paper's spiking networks (port of ``repro.models.snn``)."""
