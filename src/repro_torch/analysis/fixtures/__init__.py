"""Lint fixtures: each module DELIBERATELY violates one or more rules, so
the tests (and the gate's self-check) can assert the port's lint fires.
The default lint walk skips any ``fixtures`` directory: lint these with
``--include-fixtures`` or by passing a file path."""
