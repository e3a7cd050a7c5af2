"""The port's guard planes: static analysis over its own source
(`distlint`), its store coordination protocols (`storelint`) and `lint`,
which runs them as one gate. Host tools; no card."""
