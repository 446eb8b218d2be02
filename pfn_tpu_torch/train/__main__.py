"""``python -m pfn_tpu_torch.train``: see ``pfn_tpu_torch.train.cli``."""

if __name__ == "__main__":
    from pfn_tpu_torch.train.cli import main

    main()
