"""The benchmark's general machinery: finding a cell's parts by name,
running its closed loop, reducing a profiler trace, and judging outputs
against the plain reference."""
