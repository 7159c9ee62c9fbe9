from instruct_jax.cli import main

raise SystemExit(main())
