from . import main

if __name__ == "__main__":  # importing this module runs nothing
    main()
