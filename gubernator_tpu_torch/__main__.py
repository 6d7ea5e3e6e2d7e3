from gubernator_tpu_torch.daemon import main

main()
