"""One driver a kind of configuration (`"driver"` in its file): it builds
the system under test from the configuration and the traffic, times the
window, and compares what the window produced with the plain reference."""
