"""Traffic generators: host inputs made from the seed and a cell's
parameters. The program under test receives only what they make."""
