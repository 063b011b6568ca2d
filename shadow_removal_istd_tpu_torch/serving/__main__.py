"""``python -m shadow_removal_istd_tpu_torch.serving`` -> serving daemon."""

from shadow_removal_istd_tpu_torch.serving.server import main

raise SystemExit(main())
