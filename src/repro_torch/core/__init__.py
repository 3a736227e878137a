"""Engine core of the port: timing words, STDP maths, LIF, the engine."""
